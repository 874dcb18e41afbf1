"""K5 and K6: the forward and the sequential backward of one GRU layer
direction in training.

``gru_fwd_seq`` (K5) is the Hopper design of ``csrc/gru_fwd_hopper.cuh``
(entry points in ``csrc/gru_fwd_seq.cu``) and ``gru_bwd_seq`` (K6) that of
``csrc/gru_bwd_hopper.cuh`` (entry points in ``csrc/gru_bwd_seq.cu``); they
replace the TPU kernels ``inpaintnet_tpu/ops/gru_bwd_pallas.py
gru_fwd_seq_pallas`` and ``gru_bwd_seq_pallas`` (each source says what
bounds it on the card and how its design answers). Both run their f32
products as bf16 ``wgmma`` passes over exact bf16 pieces
(:func:`split_bf16_pieces`; :func:`pack_fwd_weights`,
:func:`pack_bwd_weights`), a cluster of CTAs sharing each 64-row tile
(:func:`fwd_plan`, :func:`bwd_plan`) and exchanging the product's operand
through an L2 scratch.
``gru_fwd_seq_reference`` and ``gru_bwd_seq_reference`` are their plain
PyTorch versions, op for op the JAX kernels':

- K5: an f32 carry; the recurrent product on h rounded to the parameter
  dtype, accumulated in f32; ``hn = h @ W_hh + b_hh`` with its bias; the
  five outputs (ys, r, z, n, hn) stored in the parameter dtype.
- K6: the gate-derivative chain in f32; the product ``dhw @ W_hh^T`` on the
  UNROUNDED f32 dhw with W_hh upcast, accumulated in f32, in every dtype;
  da, dhw and dh0 stored in the parameter dtype.

``fwd_carry``, ``fwd_product``, ``bwd_product`` and ``bwd_carry`` hold the
steps a kernel is most likely to get wrong (K5's carry precision and
product operand, K6's product operand precision and dh carry), so a check
can plant a fault in the plain versions and show that its bound rejects
it.

Up to 1024 units a tile's CTAs form a cluster. Above it they form a tile
group that spans clusters (``kernel_common.tile_plan``): the same kernels,
whose CTAs meet at each step at a release/acquire counter in global memory
instead of a cluster's mbarrier, in a persistent launch of as many groups
as the card holds at once (:func:`fwd_tile_plan`, :func:`bwd_tile_plan`),
or, for a group the card cannot hold at once, one launch a step. The data
path does not change, so a tile group's outputs equal the cluster route's
bit for bit.

Both run a layer at a width their plans take. The trainfast Function
(``ops/gru_trainfast.py``) takes every width: it runs a layer at
:func:`trainfast_width`, the next width both kernels take, on zero units
(:func:`fwd_padded_operands`), keeps K5's residuals at that width for K6,
and slices the outputs and gradients back to the layer's units.

The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from inpaintnet_tpu_torch.ops.encoder_kernel import pack_gate_blocks
from inpaintnet_tpu_torch.ops.kernel_common import (
    DTYPE_CODES,
    HOPPER_ROWS,
    HOPPER_SMEM_BUDGET,
    LAYER_MAX_HIDDEN,
    SYNC_CODES,
    LaunchPlan,
    WeightCache,
    card_tile_plan,
    check_cuda_tensor,
    check_launch,
    counts_launches,
    data_ptr,
    group_fault,
    load_kernels,
    pad_units,
    padded_gru_layer,
    padded_width,
    split_bf16_pieces,
    stream_ptr,
    tile_scratch,
    tile_units,
)


def fwd_carry(h_new: torch.Tensor) -> torch.Tensor:
    """K5's carry from one step to the next: the f32 state as it is."""
    return h_new


def fwd_product(h: torch.Tensor, w_hh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K5's recurrent product: the f32 carry rounded to the parameter dtype,
    @ f32 ``W_hh`` (H, 3H)."""
    return h.to(dtype).float() @ w_hh


def bwd_product(dhw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """K6's recurrent product: f32 ``dhw`` (B, 3H) @ f32 ``W_hh^T`` (3H, H)."""
    return dhw @ w_hh_t


def bwd_carry(dh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K6's dh carried from one step to the next: in f32, as it is."""
    return dh


def _order(seq_len: int, backwards: bool):
    return range(seq_len - 1, -1, -1) if backwards else range(seq_len)


def gru_fwd_seq_reference(w_hh: torch.Tensor, b_hh: torch.Tensor, xw: torch.Tensor,
                          h0: torch.Tensor, *, reverse: bool = False):
    """Plain version of K5.

    :param w_hh: (H, 3H); b_hh: (3H,); xw: (B, T, 3H) = x @ W_ih + b_ih;
        h0: (B, H), all in the parameter dtype
    :param reverse: run t = T-1 .. 0 (outputs stay in original time order)
    :return: (ys, r, z, n, hn), each (T, B, H) in the parameter dtype
    """
    dtype = xw.dtype
    seq_len, hidden = xw.shape[1], w_hh.shape[0]
    whh, bhh = w_hh.float(), b_hh.float()
    h = h0.float()
    outs = [[None] * seq_len for _ in range(5)]
    for t in _order(seq_len, reverse):
        xwt = xw[:, t].float()
        hw = fwd_product(h, whh, dtype) + bhh
        r = torch.sigmoid(xwt[:, :hidden] + hw[:, :hidden])
        z = torch.sigmoid(xwt[:, hidden:2 * hidden] + hw[:, hidden:2 * hidden])
        hn = hw[:, 2 * hidden:]
        n = torch.tanh(xwt[:, 2 * hidden:] + r * hn)
        h_new = (1.0 - z) * n + z * h
        for out, v in zip(outs, (h_new, r, z, n, hn)):
            out[t] = v.to(dtype)
        h = fwd_carry(h_new)
    return tuple(torch.stack(out) for out in outs)


def gru_bwd_seq_reference(w_hh: torch.Tensor, dys: torch.Tensor, r: torch.Tensor,
                          z: torch.Tensor, n: torch.Tensor, hn: torch.Tensor,
                          hprev: torch.Tensor, *, reverse: bool = False):
    """Plain version of K6.

    :param w_hh: (H, 3H) recurrent weight of the layer direction
    :param dys: (T, B, H) output cotangents; r, z, n, hn: (T, B, H) stored
        gates; hprev: (T, B, H) ``h_{t-1}`` per step (h0 at the first
        processed step), all in original time order and the parameter dtype
    :param reverse: the layer's direction (a reverse layer's backward runs
        t = 0 .. T-1, a forward one's t = T-1 .. 0)
    :return: (da (T, B, 3H), dhw (T, B, 3H), dh0 (B, H)) in the parameter dtype
    """
    dtype = dys.dtype
    seq_len = dys.shape[0]
    w_t = w_hh.float().t()
    dh = torch.zeros(dys.shape[1:], dtype=torch.float32, device=dys.device)
    da_out, dhw_out = [None] * seq_len, [None] * seq_len
    for t in _order(seq_len, not reverse):
        g = dys[t].float() + dh
        rt, zt, nt, hnt, hp = (v[t].float() for v in (r, z, n, hn, hprev))
        dn = g * (1.0 - zt)
        dz = g * (hp - nt)
        dan = dn * (1.0 - nt * nt)
        dr = dan * hnt
        dar = dr * rt * (1.0 - rt)
        daz = dz * zt * (1.0 - zt)
        dhw = torch.cat([dar, daz, dan * rt], dim=-1)
        dh = bwd_carry(g * zt + bwd_product(dhw, w_t), dtype)
        da_out[t] = torch.cat([dar, daz, dan], dim=-1).to(dtype)
        dhw_out[t] = dhw.to(dtype)
    return torch.stack(da_out), torch.stack(dhw_out), dh.to(dtype)


def trainfast_supports(hidden: int) -> bool:
    """Whether an unmasked training GRU layer of this width runs the
    trainfast autograd Function (K5 forward, K6 backward): every width in
    both dtypes (:func:`trainfast_width`; the JAX package's
    ``trainfast_pallas`` has no width gate), the LatentRNN's generation
    GRUs, narrow ones on zero units. The gate reads the width alone, on
    every device, so the CPU takes the route the card takes."""
    return all(trainfast_width(hidden, d) is not None for d in DTYPE_CODES)


@functools.lru_cache(maxsize=None)
def _trainfast_width(hidden: int, dtype):
    def takes(w):
        if w > LAYER_MAX_HIDDEN:  # tile groups: K5's and K6's units a CTA
            return w % tile_units(dtype, "K5") == 0 and w % tile_units(dtype, "K6") == 0
        return bool(fwd_cluster_sizes(w, dtype)) and bool(bwd_cluster_sizes(w, dtype))
    return padded_width(hidden, takes)


def trainfast_width(hidden: int, dtype):
    """The width the trainfast Function runs ``hidden`` units at
    (``kernel_common.padded_width``): the next width at which both K5 and
    K6 have a plan. In bf16 above 512, and in f32 above 512 for K6 (8 CTAs
    of at most 128 units), an odd number of 64-unit blocks runs one block
    wider: 576 at 640, 1024 as it is; above 1024 (tile groups of K6's
    128-unit CTAs) every multiple of 128: 1088 at 1152, 1536 as it is.
    Another dtype (the tests' float64 on the CPU) takes f32's widths."""
    return _trainfast_width(hidden, torch.bfloat16 if dtype == torch.bfloat16
                            else torch.float32)


def _check_common(name: str, w_hh: torch.Tensor, device: torch.device, dtype: torch.dtype) -> int:
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {dtype}")
    hidden = w_hh.shape[0]
    check_cuda_tensor("w_hh", w_hh, (hidden, 3 * hidden), dtype, device)
    return hidden


def fwd_padded_operands(w_hh: torch.Tensor, b_hh: torch.Tensor, xw: torch.Tensor,
                        h0: torch.Tensor, padded=None) -> tuple:
    """K5's operands at ``padded`` units (by default :func:`trainfast_width`):
    (W_hh, b_hh, xw, h0) with zero units, gate by gate
    (``kernel_common.pad_units``; W_hh and b_hh built once per weight tensor,
    ``kernel_common.padded_gru_layer``: an Adam step's in-place update
    rebuilds them). Its padded units emit r = z = 1/2, n = 0 and hn = 0;
    handed on to K6 with a zero dy, their g, da, dhw and (their rows and
    columns of W_hh being zero) dh stay exactly 0."""
    hidden = w_hh.shape[0]
    padded = padded or trainfast_width(hidden, xw.dtype)
    if padded == hidden:
        return w_hh, b_hh, xw, h0
    w, b = padded_gru_layer(w_hh, b_hh, padded=padded)
    return w, b, pad_units(xw, hidden, padded, 3), pad_units(h0, hidden, padded)


@counts_launches  # proves a run went through K5
def gru_fwd_seq(w_hh: torch.Tensor, b_hh: torch.Tensor, xw: torch.Tensor, h0: torch.Tensor,
                *, reverse: bool = False):
    """K5: arguments and result as :func:`gru_fwd_seq_reference`."""
    if xw.device.type == "cpu":
        return gru_fwd_seq_reference(w_hh, b_hh, xw, h0, reverse=reverse)
    dtype, device = xw.dtype, xw.device
    hidden = _check_common("gru_fwd_seq", w_hh, device, dtype)
    batch, seq_len = xw.shape[:2]
    tiles_plan = fwd_tile_plan(batch, hidden, dtype, device)
    if tiles_plan is None and not fwd_cluster_sizes(hidden, dtype):
        raise ValueError(f"gru_fwd_seq: no kernel for hidden size {hidden} in {dtype}")
    check_cuda_tensor("xw", xw, (batch, seq_len, 3 * hidden), dtype, device)
    check_cuda_tensor("b_hh", b_hh, (3 * hidden,), dtype, device)
    check_cuda_tensor("h0", h0, (batch, hidden), dtype, device)
    pieces = bwd_weight_pieces(dtype)
    tiles = -(-batch // HOPPER_ROWS)
    scratch = torch.empty((tiles, 2, pieces, HOPPER_ROWS, hidden), dtype=torch.bfloat16,
                          device=device)
    out = torch.empty((5, seq_len, batch, hidden), dtype=dtype, device=device)
    ptrs = (xw.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), out.data_ptr(), scratch.data_ptr())
    lib = load_kernels()
    if tiles_plan is None:
        plan = fwd_plan(hidden, dtype)
        map_addr = fwd_w_map(fwd_operands(w_hh), hidden, hidden // plan.cluster)
        err = lib.inpaint_gru_fwd_hopper(DTYPE_CODES[dtype], map_addr, *ptrs, batch, seq_len,
                                         hidden, int(reverse), plan.cluster, plan.stages,
                                         stream_ptr())
    else:
        units = tile_units(dtype, "K5")
        counters, carry = tile_scratch(tiles_plan, batch, hidden, device)
        err = lib.inpaint_gru_fwd_tiles(
            DTYPE_CODES[dtype], fwd_w_map(fwd_operands(w_hh), hidden, units), *ptrs,
            data_ptr(counters), data_ptr(carry), batch, seq_len, hidden, int(reverse),
            tiles_plan.ctas, tiles_plan.groups, fwd_ring_stages(units, pieces),
            SYNC_CODES[tiles_plan.route], group_fault(), stream_ptr())
    check_launch(err, "gru_fwd_seq")
    gru_fwd_seq.launches += 1
    return tuple(out.unbind(0))


# --------------------------------------------------------------------------- #
# K5's Hopper route (csrc/gru_fwd_hopper.cuh)
# --------------------------------------------------------------------------- #
FWD_MAX_CLUSTER = 8
FWD_MAX_F32_CLUSTER = 16  # H 1024 at 64 units a CTA: a non-portable cluster, as K8's f32 route
FWD_MAX_STAGES = 6
FWD_CARRY_PAD = 8  # f32 padding of the carry's rows in shared memory
FWD_PIECE_BYTES = HOPPER_ROWS * 128  # a 64-wide k-slab of one piece of T(h)
FWD_SLAB_BYTES = 96 * 128  # a 32-unit chunk's r, z, n rows of a W piece x 64 of K


def fwd_max_units(dtype) -> int:
    """Units a K5 CTA owns at most: in f32 64 (a consumer warpgroup's one
    32-unit chunk takes three 64 x 96 f32 accumulators: the sum and two
    k-slab partials), in bf16 128 (two chunks, one accumulator each)."""
    return 128 if dtype == torch.bfloat16 else 64


def fwd_ring_stages(units: int, pieces: int) -> int:
    """Ring stages of a K5 CTA owning ``units`` units (``gru_fwd_hopper.cuh
    smem_bytes``): a stage is a 64-wide k-slab of T(h)'s pieces (8 KB each)
    and of the CTA's gate slabs in every W piece (12 KB a 32-unit chunk),
    beside the f32 carry (64 rows of the units) and, in bf16 (one piece),
    the two output buffers of each consumer warpgroup (64 rows of
    ``units / 2 + 8`` bf16)."""
    stage = pieces * FWD_PIECE_BYTES + pieces * (units // 32) * FWD_SLAB_BYTES
    carry = HOPPER_ROWS * (units + FWD_CARRY_PAD) * 4
    staging = 2 * 2 * HOPPER_ROWS * (units // 2 + 8) * 2 if pieces == 1 else 0
    return min(FWD_MAX_STAGES, (HOPPER_SMEM_BUDGET - 1024 - carry - staging) // stage)


def fwd_cluster_sizes(hidden: int, dtype) -> list:
    """Cluster sizes K5 can run ``hidden`` units at: CTAs owning whole
    64-unit blocks, at most :func:`fwd_max_units` each, with a ring of at
    least two stages; 1-8 CTAs in bf16 (H / 64 and half of it: 8 of 128
    units at H 1024), 1-16 in f32 (H / 64, so H 1024 takes a non-portable
    cluster of 16, as K8's f32 route, ``gru_fwd_hopper.cuh`` mode
    ``kLayer``)."""
    if hidden % 64 or hidden <= 0:
        return []
    pieces = bwd_weight_pieces(dtype)
    most = FWD_MAX_CLUSTER if dtype == torch.bfloat16 else FWD_MAX_F32_CLUSTER
    return [c for c in range(1, most + 1)
            if (hidden // 64) % c == 0 and hidden // c <= fwd_max_units(dtype)
            and fwd_ring_stages(hidden // c, pieces) >= 2]


def fwd_plan(hidden: int, dtype) -> LaunchPlan:
    """How K5 runs ``hidden`` units, whatever the rows: the largest cluster
    size, so the fewest units a CTA, as :func:`bwd_plan` (each step is one
    serial chain in each CTA whose length grows with its units). Raises
    ValueError for a width no cluster size takes."""
    sizes = fwd_cluster_sizes(hidden, dtype)
    if not sizes:
        raise ValueError(f"no K5 plan for hidden size {hidden} in {dtype}")
    cluster = max(sizes)
    return LaunchPlan(cluster, fwd_ring_stages(hidden // cluster, bwd_weight_pieces(dtype)))


def fwd_tile_plan(rows: int, hidden: int, dtype, device):
    """K5's tile-group plan on the card ``device`` names
    (``kernel_common.card_tile_plan``: :func:`fwd_ring_stages` of its
    ``tile_units``), or None where its cluster route runs
    (:func:`fwd_plan`)."""
    return card_tile_plan(rows, hidden, dtype, "K5", "inpaint_gru_fwd_resident",
                          fwd_ring_stages(tile_units(dtype, "K5"), bwd_weight_pieces(dtype)),
                          device)


def pack_fwd_weights(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh (H, 3H) as K5 streams it: (pieces, H / 32, H / 64, 96, 64) bf16,
    ``encoder_kernel.pack_gate_blocks`` of each piece (one in bf16, the
    three :func:`split_bf16_pieces` in f32): element [p, c, k, 32 g + u, kk]
    is piece p of ``W_hh[64 k + kk, g H + 32 c + u]``, so one 5-D TMA box
    holds a k-slab of a CTA's consecutive chunks in every piece."""
    pieces = ([w_hh] if w_hh.dtype == torch.bfloat16 else list(split_bf16_pieces(w_hh)))
    return torch.stack([pack_gate_blocks(p) for p in pieces]).contiguous()


def _build_fwd_operands(w_hh: torch.Tensor) -> dict:
    return {"packed": pack_fwd_weights(w_hh), "maps": {}}


# K5's packed W pieces, built once per weight tensor (an Adam step's
# in-place update rebuilds them, as K6's), and their tensor maps by a CTA's
# units
fwd_operands = WeightCache(_build_fwd_operands)


def fwd_w_map(ops: dict, hidden: int, units: int) -> int:
    """The address of the tensor map of ``ops``' packed W pieces for a K5
    CTA owning ``units`` units, encoded once per size and kept with them."""
    if units not in ops["maps"]:
        packed = ops["packed"]
        buf = ctypes.create_string_buffer(128 + 64)
        addr = (ctypes.addressof(buf) + 63) // 64 * 64
        check_launch(load_kernels().inpaint_gru_fwd_w_map(packed.data_ptr(), hidden,
                                                          packed.shape[0], units, addr),
                     "gru_fwd_seq's W map")
        ops["maps"][units] = (buf, addr)
    return ops["maps"][units][1]


# --------------------------------------------------------------------------- #
# K6's Hopper route (csrc/gru_bwd_hopper.cuh)
# --------------------------------------------------------------------------- #
BWD_MAX_UNITS = 128  # units a CTA owns (three sets of partial sums in registers)
BWD_MAX_CLUSTER = 8
BWD_A_SLAB_BYTES = 3 * HOPPER_ROWS * 128  # a 64-wide k-slab of dhw's three pieces
BWD_MAX_STAGES = 6
BWD_DH_PAD = 8  # f32 padding of dh's rows in shared memory


def bwd_weight_pieces(dtype) -> int:
    """bf16 pieces of W_hh that K6 multiplies: one in bf16 (exact), three
    in f32."""
    return 1 if dtype == torch.bfloat16 else 3


def pack_bwd_weights(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh (H, 3H) as K6 streams it: (3H / 64 k-slabs, pieces, H, 64) bf16,
    element [k, p, j, kk] piece p of ``W_hh[j, 64 k + kk]`` (the product's
    B operand, K-major: row j is output unit j). A CTA's units are
    contiguous rows of each k-slab's piece; the f32 route's three pieces are
    :func:`split_bf16_pieces` of W."""
    hidden = w_hh.shape[0]
    pieces = ([w_hh] if w_hh.dtype == torch.bfloat16 else list(split_bf16_pieces(w_hh)))
    stacked = torch.stack(pieces)  # (P, H, 3H)
    return stacked.reshape(len(pieces), hidden, 3 * hidden // 64, 64).permute(2, 0, 1, 3) \
        .contiguous()


def bwd_ring_stages(units: int, pieces: int) -> int:
    """Ring stages of a K6 CTA owning ``units`` units (``gru_bwd_hopper.cuh
    smem_bytes``): a stage is a 64-wide k-slab of dhw's three pieces (24 KB)
    and of the CTA's rows of every W piece, beside dh (64 rows of the units
    in f32)."""
    stage = BWD_A_SLAB_BYTES + pieces * units * 128
    dh = HOPPER_ROWS * (units + BWD_DH_PAD) * 4
    return min(BWD_MAX_STAGES, (HOPPER_SMEM_BUDGET - 1024 - dh) // stage)


def bwd_cluster_sizes(hidden: int, dtype) -> list:
    """Cluster sizes K6 can run ``hidden`` units at: 1-8 CTAs owning whole
    64-unit blocks, at most ``BWD_MAX_UNITS`` each, with a ring of at least
    two stages."""
    if hidden % 64 or hidden <= 0:
        return []
    pieces = bwd_weight_pieces(dtype)
    return [c for c in range(1, BWD_MAX_CLUSTER + 1)
            if (hidden // 64) % c == 0 and hidden // c <= BWD_MAX_UNITS
            and bwd_ring_stages(hidden // c, pieces) >= 2]


def bwd_plan(hidden: int, dtype) -> LaunchPlan:
    """How K6 runs ``hidden`` units, whatever the rows: the largest cluster
    size, so the fewest units a CTA. A step is one serial chain in each CTA
    (its units' elementwise chain, the exchange of dhw's pieces, the
    product over all 3H of K), whose length grows with the CTA's units,
    while the total work of all CTAs barely changes with C: on an H100 at
    H 512 (PERF.md) 64 units a CTA beat 128 at the encoder's 4,096 rows and
    at the tick GRU's 16,384, in both dtypes, and 256 was slower still.
    Raises ValueError for a width no cluster size takes."""
    sizes = bwd_cluster_sizes(hidden, dtype)
    if not sizes:
        raise ValueError(f"no K6 plan for hidden size {hidden} in {dtype}")
    cluster = max(sizes)
    return LaunchPlan(cluster, bwd_ring_stages(hidden // cluster, bwd_weight_pieces(dtype)))


def bwd_tile_plan(rows: int, hidden: int, dtype, device):
    """K6's tile-group plan on the card ``device`` names (128 units a CTA,
    ``kernel_common.card_tile_plan``), or None where its cluster route runs
    (:func:`bwd_plan`)."""
    return card_tile_plan(rows, hidden, dtype, "K6", "inpaint_gru_bwd_resident",
                          bwd_ring_stages(tile_units(dtype, "K6"), bwd_weight_pieces(dtype)),
                          device)


def _build_bwd_operands(w_hh: torch.Tensor) -> dict:
    return {"packed": pack_bwd_weights(w_hh), "maps": {}}


# K6's packed W pieces, built once per weight tensor (an Adam step's
# in-place update rebuilds them), and their tensor maps by a CTA's units
bwd_operands = WeightCache(_build_bwd_operands)


def bwd_w_map(ops: dict, hidden: int, units: int) -> int:
    """The address of the tensor map of ``ops``' packed W pieces for a CTA
    owning ``units`` units, encoded once per size and kept with them."""
    if units not in ops["maps"]:
        packed = ops["packed"]
        buf = ctypes.create_string_buffer(128 + 64)
        addr = (ctypes.addressof(buf) + 63) // 64 * 64
        check_launch(load_kernels().inpaint_gru_bwd_w_map(packed.data_ptr(), hidden,
                                                          packed.shape[1], units, addr),
                     "gru_bwd_seq's W map")
        ops["maps"][units] = (buf, addr)
    return ops["maps"][units][1]


@counts_launches  # proves a run went through K6
def gru_bwd_seq(w_hh: torch.Tensor, dys: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
                n: torch.Tensor, hn: torch.Tensor, hprev: torch.Tensor, *,
                reverse: bool = False):
    """K6: arguments and result as :func:`gru_bwd_seq_reference`."""
    if dys.device.type == "cpu":
        return gru_bwd_seq_reference(w_hh, dys, r, z, n, hn, hprev, reverse=reverse)
    dtype, device = dys.dtype, dys.device
    hidden = _check_common("gru_bwd_seq", w_hh, device, dtype)
    seq_len, batch = dys.shape[:2]
    tiles_plan = bwd_tile_plan(batch, hidden, dtype, device)
    if tiles_plan is None and not bwd_cluster_sizes(hidden, dtype):
        raise ValueError(f"gru_bwd_seq: no kernel for hidden size {hidden} in {dtype}")
    for name, t in (("dys", dys), ("r", r), ("z", z), ("n", n), ("hn", hn), ("hprev", hprev)):
        check_cuda_tensor(name, t, (seq_len, batch, hidden), dtype, device)
    tiles = -(-batch // HOPPER_ROWS)
    scratch = torch.empty((tiles, 2, 3, HOPPER_ROWS, 3 * hidden), dtype=torch.bfloat16,
                          device=device)
    da = torch.empty((seq_len, batch, 3 * hidden), dtype=dtype, device=device)
    dhw = torch.empty_like(da)
    dh0 = torch.empty((batch, hidden), dtype=dtype, device=device)
    ptrs = (dys.data_ptr(), r.data_ptr(), z.data_ptr(), n.data_ptr(), hn.data_ptr(),
            hprev.data_ptr(), da.data_ptr(), dhw.data_ptr(), dh0.data_ptr(), scratch.data_ptr())
    lib = load_kernels()
    if tiles_plan is None:
        plan = bwd_plan(hidden, dtype)
        map_addr = bwd_w_map(bwd_operands(w_hh), hidden, hidden // plan.cluster)
        err = lib.inpaint_gru_bwd_hopper(DTYPE_CODES[dtype], map_addr, *ptrs, batch, seq_len,
                                         hidden, int(reverse), plan.cluster, plan.stages,
                                         stream_ptr())
    else:
        units = tile_units(dtype, "K6")
        counters, carry = tile_scratch(tiles_plan, batch, hidden, device)
        err = lib.inpaint_gru_bwd_tiles(
            DTYPE_CODES[dtype], bwd_w_map(bwd_operands(w_hh), hidden, units), *ptrs,
            data_ptr(counters), data_ptr(carry), batch, seq_len, hidden, int(reverse),
            tiles_plan.ctas, tiles_plan.groups, bwd_ring_stages(units, bwd_weight_pieces(dtype)),
            SYNC_CODES[tiles_plan.route], group_fault(), stream_ptr())
    check_launch(err, "gru_bwd_seq")
    gru_bwd_seq.launches += 1
    return da, dhw, dh0
