"""K1 and K3: final hiddens of the 2-layer bidirectional encoder GRU from
tokens.

``encoder_hn`` (K1) replaces the TPU kernel
``inpaintnet_tpu/ops/encoder_pallas.py encoder_hn_pallas``.
``encoder_hn_reference`` is its plain PyTorch version with the same
numerics: products accumulate in f32, biases and gates in f32, and the
carry and the layer-0 outputs are rounded to the parameter dtype after
every step. For f32 parameters that is exactly the XLA scan
``gru_apply(..., last_outputs=False)[1]``.

``encoder_hn_int8`` (K3) is the int8 serving twin
(``encoder_hn_pallas_int8``), with ``encoder_hn_int8_reference`` as its
plain version.

Both routes of K1, and K3, run the Hopper design of
``csrc/encoder_hopper.cuh`` (``csrc/encoder_gru.cu`` and
``csrc/encoder_gru_int8.cu`` say what bounds them and why): per chunk of
rows, layer 0's recurrence, then layer 1's input projection for every step
at once as a GEMM (``input_projection`` / ``input_projection_int8``, whose
plain versions are ``input_projection_reference`` /
``input_projection_int8_reference``), then layer 1's recurrence on it.
``encoder_hn_staged_reference`` and ``encoder_hn_int8_staged_reference``
are that staged computation in plain PyTorch. The chunk caps the GEMM's
f32 / int32 scratch at ``XW_SCRATCH_BYTES``. K1's f32 route takes its
products on the tensor cores as six bf16 passes over exact pieces
(``kernel_common.split_product`` emulates them): each layer's recurrence
is K5's f32 cluster recurrence (``csrc/gru_fwd_hopper.cuh``), layer 0
writing its outputs as the GEMM's pieces, and the GEMM is the split one
(:func:`encoder_f32_operands` packs the weights' pieces once per weight
tensor). ``recurrent_product`` is the plain version's product on h, where a
check can plant the fault "h taken as one bf16 piece".

K1's training mode (``keep=``, ``rate=``; the TPU kernel's ``keep``/``rate``
arguments, ``encoder_pallas.py:147-177``, applied between its two
``pallas_call``s at ``:257-267``) drops layer 0's outputs by a bool (B, T,
2H) keep mask before layer 1 reads them: ``where(keep, y / (1 - rate), 0)``
with a true f32 division, rounded once to the parameter dtype, while the
carry and h_n stay undropped. The kernels do it in layer 0's own store
(``csrc/encoder_gru.cu``); :func:`encoder_hn_reference` and
:func:`encoder_hn_staged_reference` are its plain versions.

Both take every width up to 512, and in bf16 masters up to 577
(``kernel_common.encoder_width``): a width that is not whole 64-unit blocks
runs at the next one that is, on zero units (:func:`encoder_padded_operands`),
and h_n is sliced back. In K3 a zero column quantizes to q = 0 at the
floored scale (``quantize.quantize_cols_int8``) and a padded h to 0, so no
real unit's product, scale or bound moves. Above 512 units K1's bf16
recurrence block runs two consumer warpgroups, not four
(:func:`encoder_consumers`).

The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from inpaintnet_tpu_torch.ops.distributions import apply_dropout
from inpaintnet_tpu_torch.ops.kernel_common import (
    CELL_KEYS,
    DTYPE_CODES,
    HOPPER_ROWS,
    HOPPER_SMEM_BUDGET,
    WeightCache,
    check_cuda_tensor,
    check_launch,
    counts_launches,
    encoder_quantizes,
    encoder_width,
    gru_gates_f32,
    load_kernels,
    pad_cell,
    pad_units,
    padded_cache,
    round_up,
    split_bf16_pieces,
    stream_ptr,
    unpad_units,
)
from inpaintnet_tpu_torch.ops.quantize import (
    H_SCALE,
    dequantize_h,
    quantize_cols_int8,
    quantize_h_int8,
)


def fused_tables(gru_params, emb_table: torch.Tensor):
    """Layer 0's embedding-then-input-projection as one (V, 3H) table per
    direction, ``emb @ W_ih`` in f32 rounded once to the parameter dtype
    (computed outside the kernel, as the TPU kernel's tables are)."""
    dtype = gru_params[0][0]["w_hh"].dtype
    return [(emb_table.float() @ p["w_ih"].float()).to(dtype) for p in gru_params[0]]


# The Hopper kernels' geometry (csrc/encoder_hopper.cuh)
REC_ROWS = 64  # rows of a recurrence block
GATE_UNITS = 32  # hidden units of a gate chunk: its r, z, n rows form one W slab
REC_STAGE_BYTES = 3 * GATE_UNITS * 128  # one W_hh k-slab of a chunk: 12 KB
REC_STAGES = {2: 2, 1: 3}  # ring stages a consumer warpgroup, by h's bytes: bf16, int8
# Largest f32 / int32 layer-1 projection scratch a call allocates: the rows
# are encoded in chunks of a power of two of rows under it (8,192 rows of
# 24 steps at H 512: 2.4 GB).
XW_SCRATCH_BYTES = 5 * 2**29  # 2.5 GiB


def encoder_chunk_rows(batch: int, seq_len: int, hidden: int, max_chunk_rows=None,
                       dtype=torch.bfloat16) -> int:
    """Rows of one chunk of the Hopper route: the largest power of two
    (from 64) whose (2, steps, rows, 3H) 4-byte projection fits
    ``XW_SCRATCH_BYTES`` (in f32 beside layer 0's outputs as three bf16
    pieces and the h-piece exchange of both directions: half bf16's rows),
    at most ``max_chunk_rows`` and ``batch``."""
    per_row = 2 * seq_len * 3 * hidden * 4
    if dtype == torch.float32:
        per_row += seq_len * 2 * hidden * 3 * 2 + 2 * 2 * 3 * hidden * 2
    rows = REC_ROWS
    while 2 * rows * per_row <= XW_SCRATCH_BYTES:
        rows *= 2
    if max_chunk_rows is not None:
        rows = min(rows, max_chunk_rows)
    return max(1, min(rows, batch))


def encoder_rec_smem_bytes(hidden: int, elem_bytes: int, consumers: int) -> int:
    """Dynamic shared memory of a K1 bf16 (``elem_bytes`` 2) or K3 (1)
    recurrence block (``csrc/encoder_hopper.cuh rec_smem_bytes``): two 64-row
    h tiles of K padded to whole 128-byte k-slabs, and each consumer
    warpgroup's ring."""
    padded_k = round_up(hidden, 128 // elem_bytes)
    return (2 * REC_ROWS * padded_k * elem_bytes
            + consumers * REC_STAGES[elem_bytes] * REC_STAGE_BYTES + 1024)


def encoder_consumers(hidden: int, elem_bytes: int) -> int:
    """Consumer warpgroups of a K1 bf16 / K3 recurrence block: 4 where their
    rings fit beside the two h tiles (every width up to 512, and K3's up to
    640: 2 x 64 x 640 int8 + 4 x 3 x 12 KB), else 2 (K1 bf16 above 512: at
    640, 160 KB of tiles + 2 x 2 x 12 KB)."""
    return 4 if encoder_rec_smem_bytes(hidden, elem_bytes, 4) <= HOPPER_SMEM_BUDGET else 2


def encoder_cuda_launches(dtype, batch: int, seq_len: int, hidden: int,
                          max_chunk_rows=None) -> int:
    """CUDA kernel launches of one K1/K3 call: three a chunk (layer 0, the
    GEMM, layer 1), in every dtype (a narrow H runs at round_up(H, 64))."""
    hidden = round_up(hidden, 64)
    chunk = encoder_chunk_rows(batch, seq_len, hidden, max_chunk_rows, dtype)
    return 3 * -(-batch // chunk)


def pack_gate_slabs(w_hh: torch.Tensor, k_multiple: int) -> torch.Tensor:
    """A (H, 3H) recurrent weight as the Hopper recurrence reads it: W^T,
    (3H, Hk) K-major, its rows reordered so that each 32-unit chunk's r, z
    and n rows sit together (chunk c: rows [96c, 96c + 96) hold W's columns
    [32c, +32), [H + 32c, +32), [2H + 32c, +32)), K zero-padded to
    ``Hk = round_up(H, k_multiple)``."""
    hidden = w_hh.shape[0]
    wt = w_hh.t().reshape(3, hidden // GATE_UNITS, GATE_UNITS, hidden)
    wt = wt.permute(1, 0, 2, 3).reshape(3 * hidden, hidden)
    pad = round_up(hidden, k_multiple) - hidden
    return torch.nn.functional.pad(wt, (0, pad)).contiguous() if pad else wt.contiguous()


def pack_gate_blocks(w_hh: torch.Tensor) -> torch.Tensor:
    """A (H, 3H) recurrent weight as K8's and K2's Hopper recurrences
    stream it: :func:`pack_gate_slabs`' rows (W^T, each 32-unit chunk's r, z
    and n rows together) with each chunk's 64-wide k-slabs made contiguous,
    (H / 32 chunks, H / 64 k-slabs, 96, 64): one TMA box then loads
    consecutive k-slabs of a chunk in one piece."""
    hidden = w_hh.shape[0]
    slabs = pack_gate_slabs(w_hh, 64).reshape(hidden // GATE_UNITS, 3 * GATE_UNITS,
                                              hidden // 64, 64)
    return slabs.permute(0, 2, 1, 3).contiguous()


def recurrent_product(h: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The plain K1's product on h: the carry in f32 @ f32 ``W_hh`` (one
    place, so a check can plant h taken as one bf16 piece)."""
    return h.float() @ w_hh


def _gru_direction(p, xw_at, reverse: bool, batch: int, seq_len: int, dtype, device):
    """One direction of a plain encoder layer: the carry rounded to
    ``dtype`` every step. :return: (outputs by step, last carry)"""
    hidden = p["w_hh"].shape[0]
    h = torch.zeros((batch, hidden), dtype=dtype, device=device)
    whh, bhh = p["w_hh"].float(), p["b_hh"].float()
    ys = [None] * seq_len
    for t in (range(seq_len - 1, -1, -1) if reverse else range(seq_len)):
        hw = recurrent_product(h, whh) + bhh
        h = gru_gates_f32(xw_at(t), hw, h.float(), hidden).to(dtype)
        ys[t] = h
    return ys, h


def _layer0_reference(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor,
                      keep=None, rate: float = 0.0):
    """Layer 0 of the plain K1: (outputs [forward, backward] by step, [h_n
    forward, h_n backward]); with ``keep``, the outputs are the dropped
    ones layer 1 reads (the carry and h_n are not dropped)."""
    dtype = gru_params[0][0]["w_hh"].dtype
    batch, seq_len = tokens.shape
    hidden = gru_params[0][0]["w_hh"].shape[0]
    tokens = tokens.long()
    ys0, h_n = [], []
    for d, (p, tab) in enumerate(zip(gru_params[0], fused_tables(gru_params, emb_table))):
        bih = p["b_ih"].float()
        ys, h = _gru_direction(p, lambda t, tab=tab, bih=bih: tab[tokens[:, t]].float() + bih,
                               d == 1, batch, seq_len, dtype, tokens.device)
        if keep is not None:
            ys = [apply_dropout(y, keep[:, t, d * hidden:(d + 1) * hidden], rate)
                  for t, y in enumerate(ys)]
        ys0.append(ys)
        h_n.append(h)
    return ys0, h_n


def encoder_hn_reference(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor,
                         keep=None, rate: float = 0.0) -> torch.Tensor:
    """Plain version of K1, layer 1's input projection taken step by step.
    ``keep`` (bool (B, T, 2H), [:, :, :H] forward) and ``rate``: the
    training mode (``apply_dropout`` on layer 0's outputs).
    :return: h_n (4, B, H) [l0f, l0b, l1f, l1b] in the parameter dtype."""
    dtype = gru_params[0][0]["w_hh"].dtype
    batch, seq_len = tokens.shape
    ys0, h_n = _layer0_reference(gru_params, emb_table, tokens, keep, rate)
    for d, p in enumerate(gru_params[1]):
        wih, bih = p["w_ih"].float(), p["b_ih"].float()
        _, h = _gru_direction(p, lambda t, wih=wih, bih=bih:
                              torch.cat([ys0[0][t], ys0[1][t]], dim=-1).float() @ wih + bih,
                              d == 1, batch, seq_len, dtype, tokens.device)
        h_n.append(h)
    return torch.stack(h_n, dim=0)


def input_projection_reference(ys: torch.Tensor, w_ih: torch.Tensor,
                               b_ih: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's GEMM: layer 1's input projection for every
    step at once, summed in f32 and biased in f32 after the sum.

    :param ys: (M, 2H) layer-0 outputs [forward | backward], M = steps x rows
    :param w_ih: (2, 2H, 3H) per direction; ``b_ih``: (2, 3H)
    :return: (2, M, 3H) f32
    """
    return ys.float() @ w_ih.float() + b_ih.float()[:, None]


def _stack_layer1(gru_params, key: str) -> torch.Tensor:
    return torch.stack([p[key] for p in gru_params[1]])


def chunk_keep(keep: torch.Tensor, row0: int, rows: int) -> torch.Tensor:
    """The training mode's mask for a chunk: its global rows [row0, row0 +
    rows), which the kernels read as ``row0 + r``."""
    return keep[row0:row0 + rows]


def encoder_hn_staged_reference(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor,
                                keep=None, rate: float = 0.0,
                                max_chunk_rows=None) -> torch.Tensor:
    """K1 staged as the Hopper route runs it, in plain PyTorch: layer 0,
    then :func:`input_projection_reference` over every step at once, then
    layer 1's recurrence reading it. Equals :func:`encoder_hn_reference` up
    to the f32 sums' blocking. ``keep``/``rate``: the training mode. With
    ``max_chunk_rows``, chunk by chunk of :func:`encoder_chunk_rows` rows
    as the wrapper launches, each chunk reading its rows of ``keep``."""
    if max_chunk_rows is not None:
        batch, seq_len = tokens.shape
        hidden = gru_params[0][0]["w_hh"].shape[0]
        chunk = encoder_chunk_rows(batch, seq_len, hidden, max_chunk_rows,
                                   gru_params[0][0]["w_hh"].dtype)
        return torch.cat([encoder_hn_staged_reference(
            gru_params, emb_table, tokens[r0:r0 + chunk],
            None if keep is None else chunk_keep(keep, r0, min(chunk, batch - r0)), rate)
            for r0 in range(0, batch, chunk)], dim=1)
    dtype = gru_params[0][0]["w_hh"].dtype
    batch, seq_len = tokens.shape
    ys0, h_n = _layer0_reference(gru_params, emb_table, tokens, keep, rate)
    ys = torch.stack([torch.cat([f, b], dim=-1) for f, b in zip(*ys0)])  # (T, B, 2H)
    xw = input_projection_reference(ys.reshape(seq_len * batch, -1),
                                    _stack_layer1(gru_params, "w_ih"),
                                    _stack_layer1(gru_params, "b_ih"))
    xw = xw.reshape(2, seq_len, batch, -1)
    for d, p in enumerate(gru_params[1]):
        _, h = _gru_direction(p, lambda t, d=d: xw[d, t], d == 1, batch, seq_len, dtype,
                              tokens.device)
        h_n.append(h)
    return torch.stack(h_n, dim=0)


def _build_padded_encoder(*weights, padded: int) -> list:
    """The 2-layer bidirectional GRU of ``weights`` (16 tensors: [l0f, l0b,
    l1f, l1b] x ``CELL_KEYS``) at ``padded`` units."""
    hidden = weights[1].shape[0]
    cells = [dict(zip(CELL_KEYS, weights[4 * i:4 * i + 4])) for i in range(4)]

    def concat_rows(w):  # layer 1 reads [forward H | backward H]: padded in two places
        return pad_units(w, hidden, padded, 2, dim=0)
    return [[pad_cell(c, hidden, padded, 3) for c in cells[:2]],
            [pad_cell(c, hidden, padded, 3, concat_rows) for c in cells[2:]]]


# K1's and K3's GRU at the width they run it at, built once per set of
# weight tensors
padded_encoder = padded_cache(_build_padded_encoder)


def encoder_padded_operands(gru_params, keep=None, padded=None) -> tuple:
    """K1's and K3's operands at ``encoder_width(H)`` units (or ``padded``):
    the GRU with zero units (``kernel_common.pad_cell``; layer 1's W_ih rows
    padded in both halves of the [forward | backward] concat), and the
    training mode's keep mask (B, T, 2H) padded in both halves (a padded
    unit's output is 0, dropped or kept). The plain versions on them,
    sliced back to H units, are the plain versions at H; the embedding and
    tokens are unchanged. -> (gru_params, keep)"""
    hidden = gru_params[0][0]["w_hh"].shape[0]
    padded = padded or encoder_width(hidden, gru_params[0][0]["w_hh"].dtype)
    params = padded_encoder(*(p[k] for layer in gru_params for p in layer for k in CELL_KEYS),
                            padded=padded)
    return params, None if keep is None else pad_units(keep, hidden, padded, 2)


def _encoder_hidden(name: str, gru_params) -> int:
    """H of a 2-layer bidirectional GRU; raises ValueError on another."""
    if len(gru_params) != 2 or len(gru_params[0]) != 2 or len(gru_params[1]) != 2:
        raise ValueError(f"{name}: takes a 2-layer bidirectional GRU")
    return gru_params[0][0]["w_hh"].shape[0]


def _check_encoder_args(name: str, gru_params, emb_table: torch.Tensor, tokens: torch.Tensor):
    """The K1/K3 wrappers' checks of what the kernels take. -> (hidden,
    parameter dtype, device); raises ValueError otherwise."""
    _encoder_hidden(name, gru_params)
    (p0f, p0b), (p1f, p1b) = gru_params
    device, dtype = tokens.device, p0f["w_hh"].dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {dtype}")
    hidden = p0f["w_hh"].shape[0]
    if encoder_width(hidden, dtype) != hidden:
        raise ValueError(f"{name}: no kernel for hidden size {hidden} in {dtype}")
    batch, seq_len = tokens.shape
    vocab, emb_dim = emb_table.shape
    check_cuda_tensor("tokens", tokens, (batch, seq_len), torch.int32, device)
    check_cuda_tensor("emb_table", emb_table, (vocab, emb_dim), dtype, device)
    for tag, p, in_dim in (("l0f", p0f, emb_dim), ("l0b", p0b, emb_dim),
                           ("l1f", p1f, 2 * hidden), ("l1b", p1b, 2 * hidden)):
        check_cuda_tensor(f"{tag}.w_ih", p["w_ih"], (in_dim, 3 * hidden), dtype, device)
        check_cuda_tensor(f"{tag}.w_hh", p["w_hh"], (hidden, 3 * hidden), dtype, device)
        check_cuda_tensor(f"{tag}.b_ih", p["b_ih"], (3 * hidden,), dtype, device)
        check_cuda_tensor(f"{tag}.b_hh", p["b_hh"], (3 * hidden,), dtype, device)
    return hidden, dtype, device


def _check_projection_args(name: str, ys: torch.Tensor, w_ih: torch.Tensor, dtype):
    """-> (rows M, hidden); raises ValueError on what the GEMM does not take
    (in f32 the widths of f32 masters, else those of bf16 ones)."""
    if ys.dim() != 2 or ys.shape[1] % 2:
        raise ValueError(f"{name}: ys must be (M, 2H), got {tuple(ys.shape)}")
    rows, hidden = ys.shape[0], ys.shape[1] // 2
    masters = torch.float32 if dtype == torch.float32 else torch.bfloat16
    if encoder_width(hidden, masters) != hidden:
        raise ValueError(f"{name}: no kernel for hidden size {hidden}")
    check_cuda_tensor("ys", ys, (rows, 2 * hidden), dtype, ys.device)
    check_cuda_tensor("w_ih", w_ih, (2, 2 * hidden, 3 * hidden), dtype, ys.device)
    return rows, hidden


def split_weight_pieces(w: torch.Tensor) -> torch.Tensor:
    """(dirs, K, N) f32 weights as the split GEMM streams them: (dirs, 3, N,
    K) bf16, the pieces (``kernel_common.split_bf16_pieces``) of each
    direction's W^T, K-major."""
    return torch.stack([torch.stack(split_bf16_pieces(wd.t())) for wd in w]).contiguous()


def input_projection(ys: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor) -> torch.Tensor:
    """K1's GEMM on its own (the wrapper of the encoder runs it per chunk):
    :func:`input_projection_reference`'s function, f32 out, through the TMA +
    wgmma kernels (``csrc/encoder_hopper.cuh``): bf16 operands, or f32 ones
    split into three bf16 pieces each (six passes a k-slab)."""
    if ys.device.type == "cpu":
        return input_projection_reference(ys, w_ih, b_ih)
    rows, hidden = _check_projection_args("input_projection", ys, w_ih, ys.dtype)
    check_cuda_tensor("b_ih", b_ih, (2, 3 * hidden), torch.float32, ys.device)
    out = torch.empty((2, rows, 3 * hidden), dtype=torch.float32, device=ys.device)
    lib = load_kernels()
    if ys.dtype == torch.float32:
        a, w = torch.stack(split_bf16_pieces(ys)).contiguous(), split_weight_pieces(w_ih)
        err = lib.inpaint_encoder_gemm_f32(a.data_ptr(), w.data_ptr(), b_ih.data_ptr(),
                                           out.data_ptr(), rows, hidden, stream_ptr())
    elif ys.dtype == torch.bfloat16:
        w_t = w_ih.transpose(1, 2).contiguous()
        err = lib.inpaint_encoder_gemm_bf16(ys.data_ptr(), w_t.data_ptr(), b_ih.data_ptr(),
                                            out.data_ptr(), rows, hidden, stream_ptr())
    else:
        raise ValueError(f"input_projection: no kernel for dtype {ys.dtype}")
    check_launch(err, "input_projection")
    return out


def pack_f32_gate_pieces(w_f: torch.Tensor, w_b: torch.Tensor) -> torch.Tensor:
    """A layer's f32 W_hh of both directions as K1's f32 recurrence streams
    them: (2, 3, H / 32, H / 64, 96, 64) bf16, direction-major, each
    direction's three pieces as :func:`pack_gate_blocks` (K5's
    ``pack_fwd_weights``), so a 5-D TMA box over the direction's pieces
    holds a k-slab of a CTA's chunks."""
    return torch.stack([torch.stack([pack_gate_blocks(p) for p in split_bf16_pieces(w)])
                        for w in (w_f, w_b)]).contiguous()


def _build_encoder_f32_operands(whh0_f, whh0_b, wih1_f, wih1_b, whh1_f, whh1_b) -> dict:
    hidden = whh0_f.shape[0]
    whh = [pack_f32_gate_pieces(whh0_f, whh0_b), pack_f32_gate_pieces(whh1_f, whh1_b)]
    maps = []
    for packed in whh:
        buf = ctypes.create_string_buffer(128 + 64)
        addr = (ctypes.addressof(buf) + 63) // 64 * 64
        check_launch(load_kernels().inpaint_encoder_w_map_f32(packed.data_ptr(), hidden, 64, addr),
                     "encoder_hn's W map")
        maps.append((buf, addr))
    return {"whh": whh, "maps": maps, "wih1": split_weight_pieces(torch.stack([wih1_f, wih1_b]))}


# K1's f32 operands, built once per set of weight tensors: both layers' W_hh
# pieces of both directions (:func:`pack_f32_gate_pieces`) with their tensor
# maps for 64 units a CTA, and W_ih1^T's pieces (:func:`split_weight_pieces`)
encoder_f32_operands = WeightCache(_build_encoder_f32_operands)


def _encode_chunks(rec, gemm, batch: int, seq_len: int, chunk: int, ys, xw) -> None:
    """The Hopper route's launches, chunk by chunk of ``chunk`` rows:
    ``rec(layer, ys, xw, row0, rows)`` runs a layer's recurrence, ``gemm(ys,
    xw, m)`` the projection, through the scratch ys (layer 0's outputs) and
    xw (2, steps * rows, 3H)."""
    for row0 in range(0, batch, chunk):
        rows = min(chunk, batch - row0)
        rec(0, ys, xw, row0, rows)
        gemm(ys, xw, seq_len * rows)
        rec(1, ys, xw, row0, rows)


def _scratch(chunk: int, seq_len: int, hidden: int, ys_dtype, xw_dtype, device, pieces=1):
    """A chunk's scratch: layer 0's outputs ((pieces,) steps, rows, 2H) and
    the projection (2, steps * rows, 3H)."""
    return (torch.empty((pieces * seq_len * chunk * 2 * hidden,), dtype=ys_dtype, device=device),
            torch.empty((2 * seq_len * chunk * 3 * hidden,), dtype=xw_dtype, device=device))


def _check_keep(keep, rate: float, batch: int, seq_len: int, hidden: int, device):
    """The training mode's mask as the kernels read it: (B, T, 2H) uint8 (a
    view of the bool mask), or None. Raises on a mask the kernels do not take."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"encoder_hn: dropout rate {rate} outside [0, 1)")
    if keep is None:
        return None
    check_cuda_tensor("keep", keep, (batch, seq_len, 2 * hidden), torch.bool, device)
    return keep.view(torch.uint8)


@counts_launches  # proves a run went through K1
def encoder_hn(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor,
               max_chunk_rows=None, keep=None, rate: float = 0.0) -> torch.Tensor:
    """K1: h_n (4, B, H) of the 2-layer bidirectional GRU over
    ``emb_table[tokens]``.

    :param gru_params: ``[layer][direction]`` dicts, (in, 3H) weights, f32 or bf16
    :param emb_table: (V, E) in the parameter dtype
    :param tokens: (B, T) int32 in [0, V)
    :param max_chunk_rows: caps the rows of a chunk below the scratch's own
        cap (for tests of the chunking)
    :param keep: the training mode's inter-layer dropout keep mask, bool (B,
        T, 2H) ([:, :, :H] forward, [:, :, H:] backward), contiguous, or
        None (inference: what it launched before)
    :param rate: the dropout rate the kept outputs are scaled by
    """
    if tokens.device.type == "cpu":
        return encoder_hn_reference(gru_params, emb_table, tokens, keep, rate)
    if tokens.device.type != "cuda":
        raise ValueError(f"encoder_hn: no kernel for device {tokens.device}")
    hidden = _encoder_hidden("encoder_hn", gru_params)
    padded = encoder_width(hidden, gru_params[0][0]["w_hh"].dtype)
    if padded not in (None, hidden):  # zero units up to whole 64-unit blocks
        params, keep = encoder_padded_operands(gru_params, keep)
        return unpad_units(encoder_hn(params, emb_table, tokens, max_chunk_rows, keep, rate),
                           hidden, padded)
    hidden, dtype, device = _check_encoder_args("encoder_hn", gru_params, emb_table, tokens)
    batch, seq_len = tokens.shape
    keep_u8 = _check_keep(keep, rate, batch, seq_len, hidden, device)
    # layer 0's only: None for layer 1
    keep_ptr = {0: None if keep_u8 is None else keep_u8.data_ptr(), 1: None}
    vocab = emb_table.shape[0]
    h_n = torch.empty((4, batch, hidden), dtype=dtype, device=device)
    # layer 0's input projection with b_ih added, as the plain version adds it
    xtab = torch.stack([tab.float() + p["b_ih"].float() for tab, p in
                        zip(fused_tables(gru_params, emb_table), gru_params[0])]).contiguous()
    b = {f"{k}{i}": torch.stack([p[k].float() for p in gru_params[i]])
         for i in (0, 1) for k in ("b_ih", "b_hh")}
    lib = load_kernels()
    chunk = encoder_chunk_rows(batch, seq_len, hidden, max_chunk_rows, dtype)

    if dtype == torch.float32:
        from inpaintnet_tpu_torch.ops.gru_train_kernel import fwd_plan

        ops = encoder_f32_operands(*(p[k] for k, i in (("w_hh", 0), ("w_ih", 1), ("w_hh", 1))
                                     for p in gru_params[i]))
        plan = fwd_plan(hidden, dtype)
        # the h-piece exchange of both directions: (2, tiles, 2, 3, 64, H) bf16
        exchange = torch.empty((2 * -(-chunk // HOPPER_ROWS) * 2 * 3 * HOPPER_ROWS * hidden,),
                               dtype=torch.bfloat16, device=device)

        def rec(layer, ys, xw, row0, rows):
            check_launch(lib.inpaint_encoder_rec_f32(
                layer, ops["maps"][layer][1], tokens.data_ptr(), xtab.data_ptr(), xw.data_ptr(),
                b[f"b_hh{layer}"].data_ptr(), ys.data_ptr(), h_n[2 * layer].data_ptr(),
                exchange.data_ptr(), keep_ptr[layer], batch, row0, rows, seq_len, hidden,
                vocab, plan.cluster, plan.stages, 1.0 - rate, stream_ptr()), "encoder_hn")

        def gemm(ys, xw, m):
            check_launch(lib.inpaint_encoder_gemm_f32(
                ys.data_ptr(), ops["wih1"].data_ptr(), b["b_ih1"].data_ptr(), xw.data_ptr(), m,
                hidden, stream_ptr()), "encoder_hn")

        scratch = _scratch(chunk, seq_len, hidden, torch.bfloat16, torch.float32, device, 3)
    else:
        whh0, whh1 = (torch.stack([pack_gate_slabs(p["w_hh"], 64) for p in layer])
                      for layer in gru_params)
        wih1_t = torch.stack([p["w_ih"].t() for p in gru_params[1]]).contiguous()
        consumers = encoder_consumers(hidden, 2)

        def rec(layer, ys, xw, row0, rows):
            args = ((whh0, tokens, xtab, None, b["b_ih0"], b["b_hh0"]) if layer == 0 else
                    (whh1, None, None, xw, b["b_ih1"], b["b_hh1"]))
            check_launch(lib.inpaint_encoder_rec_bf16(
                layer, *(None if a is None else a.data_ptr() for a in args), ys.data_ptr(),
                h_n[2 * layer].data_ptr(), keep_ptr[layer], batch, row0, rows, seq_len,
                hidden, vocab, consumers, 1.0 - rate, stream_ptr()), "encoder_hn")

        def gemm(ys, xw, m):
            check_launch(lib.inpaint_encoder_gemm_bf16(
                ys.data_ptr(), wih1_t.data_ptr(), b["b_ih1"].data_ptr(), xw.data_ptr(), m,
                hidden, stream_ptr()), "encoder_hn")

        scratch = _scratch(chunk, seq_len, hidden, dtype, torch.float32, device)
    _encode_chunks(rec, gemm, batch, seq_len, chunk, *scratch)
    encoder_hn.launches += 1
    return h_n


# --------------------------------------------------------------------------- #
# K3: the int8 twin of K1
# --------------------------------------------------------------------------- #
def encoder_int8_operands(gru_params, emb_table: torch.Tensor) -> dict:
    """K3's quantized operands, computed per call outside the kernel as the
    TPU kernel's are (``encoder_pallas.py:473-492``), from the f32 upcast of
    the parameters. Per direction d (0 forward, 1 backward):

    - ``tab_q`` (2, V, 3H) int8: layer 0's table ``emb @ W_ih`` taken in f32
      and quantized directly (never rounded to the parameter dtype first);
    - ``whh0_q`` (2, H, 3H), ``wih1_q`` (2, 2H, 3H), ``whh1_q``: int8 weights;
    - scales (2, 3H) f32: ``s_x0`` (table), ``s_h0``, ``s_x1``, ``s_h1``,
      with the dequant ``1/127`` of an int8 hidden folded into every scale
      whose product reads one (all but the table's);
    - biases (2, 3H) f32: ``bih0``, ``bhh0``, ``bih1``, ``bhh1``.
    """
    h_dq = 1.0 / H_SCALE
    (p0f, p0b), (p1f, p1b) = gru_params[0], gru_params[1]
    out = {"tab_q": [], "whh0_q": [], "wih1_q": [], "whh1_q": []}
    scales = {"s_x0": [], "s_h0": [], "s_x1": [], "s_h1": []}
    for p0, p1 in ((p0f, p1f), (p0b, p1b)):
        for name, w, s_name, fold in (
                ("tab_q", emb_table.float() @ p0["w_ih"].float(), "s_x0", False),
                ("whh0_q", p0["w_hh"], "s_h0", True),
                ("wih1_q", p1["w_ih"], "s_x1", True),
                ("whh1_q", p1["w_hh"], "s_h1", True)):
            q, s = quantize_cols_int8(w)
            out[name].append(q)
            scales[s_name].append(s[0] * h_dq if fold else s[0])
    out = {k: torch.stack(v) for k, v in {**out, **scales}.items()}
    for name, layer, key in (("bih0", 0, "b_ih"), ("bhh0", 0, "b_hh"),
                             ("bih1", 1, "b_ih"), ("bhh1", 1, "b_hh")):
        out[name] = torch.stack([p[key].float() for p in gru_params[layer]])
    return out


def encoder_hn_int8_reference(gru_params, emb_table: torch.Tensor,
                              tokens: torch.Tensor) -> torch.Tensor:
    """Plain version of K3. Every product is int8 x int8 summed exactly (the
    int8 values are held in f32, whose sums stay exact below 2^24: at most
    127^2 * 1024 here; TF32 must be off), dequantized ``acc * scale + bias``
    in f32; the gates run in f32; the carry and the layer-0 outputs are
    stored as ``round(h * 127)`` in int8.

    :return: h_n (4, B, H) [l0f, l0b, l1f, l1b] in the parameter dtype: the
        unquantized f32 state of the last step rounded once, not the
        dequantized int8 carry
    """
    return encoder_int8_layers_reference(gru_params, emb_table, tokens)[0]


def _int8_direction(d, whh_q, s_h, bhh, xw_at, batch: int, seq_len: int, device):
    """One direction of a plain K3 layer. :return: (int8 carries by step,
    the last step's unquantized f32 state)"""
    hidden = whh_q.shape[0]
    h_q = torch.zeros((batch, hidden), dtype=torch.int8, device=device)
    whh = whh_q.float()
    ys = [None] * seq_len
    h_new = None
    for t in (range(seq_len - 1, -1, -1) if d == 1 else range(seq_len)):
        hw = (h_q.float() @ whh) * s_h + bhh
        h_new = gru_gates_f32(xw_at(t), hw, dequantize_h(h_q), hidden)
        h_q = quantize_h_int8(h_new)
        ys[t] = h_q
    return ys, h_new


def _int8_layer0_reference(ops, tokens: torch.Tensor):
    """Layer 0 of the plain K3: (int8 outputs [forward, backward] by step,
    [f32 last states])."""
    batch, seq_len = tokens.shape
    tokens = tokens.long()
    h_n, ys0 = [], []
    for d in range(2):
        tab_q, s_x, bih = ops["tab_q"][d], ops["s_x0"][d], ops["bih0"][d]
        ys, h = _int8_direction(d, ops["whh0_q"][d], ops["s_h0"][d], ops["bhh0"][d],
                                lambda t, tab_q=tab_q, s_x=s_x, bih=bih:
                                tab_q[tokens[:, t]].float() * s_x + bih,
                                batch, seq_len, tokens.device)
        ys0.append(ys)
        h_n.append(h)
    return ys0, h_n


def encoder_int8_layers_reference(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor):
    """:func:`encoder_hn_int8_reference` with its int8 layer-0 slab.

    :return: (h_n (4, B, H), ys (2, T, B, H) int8 [forward, backward])
    """
    dtype = gru_params[0][0]["w_hh"].dtype
    batch, seq_len = tokens.shape
    ops = encoder_int8_operands(gru_params, emb_table)
    ys0, h_n = _int8_layer0_reference(ops, tokens)
    for d in range(2):
        wih = ops["wih1_q"][d].float()
        s_x, bih = ops["s_x1"][d], ops["bih1"][d]
        _, h = _int8_direction(d, ops["whh1_q"][d], ops["s_h1"][d], ops["bhh1"][d],
                               lambda t: (torch.cat([ys0[0][t], ys0[1][t]], dim=-1).float()
                                          @ wih) * s_x + bih,
                               batch, seq_len, tokens.device)
        h_n.append(h)
    h_n = torch.stack(h_n, dim=0).to(dtype)
    return h_n, torch.stack([torch.stack(ys) for ys in ys0])


def input_projection_int8_reference(ys_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's GEMM: layer 1's int8 input product for every
    step at once, exact int32 sums held in f32 (exact below 2^24: at most
    127^2 x 1024 here; TF32 must be off).

    :param ys_q: (M, 2H) int8 layer-0 outputs [forward | backward]
    :param w_q: (2, 2H, 3H) int8 per direction
    :return: (2, M, 3H) f32 holding integers
    """
    return ys_q.float() @ w_q.float()


def encoder_hn_int8_staged_reference(gru_params, emb_table: torch.Tensor,
                                     tokens: torch.Tensor) -> torch.Tensor:
    """K3 staged as the Hopper route runs it, in plain PyTorch: layer 0, then
    :func:`input_projection_int8_reference` over every step at once, then
    layer 1's recurrence dequantizing it. Bit-equal to
    :func:`encoder_hn_int8_reference`: the sums are exact in any order."""
    dtype = gru_params[0][0]["w_hh"].dtype
    batch, seq_len = tokens.shape
    ops = encoder_int8_operands(gru_params, emb_table)
    ys0, h_n = _int8_layer0_reference(ops, tokens)
    ys = torch.stack([torch.cat([f, b], dim=-1) for f, b in zip(*ys0)])  # (T, B, 2H)
    acc = input_projection_int8_reference(ys.reshape(seq_len * batch, -1), ops["wih1_q"])
    acc = acc.reshape(2, seq_len, batch, -1)
    for d in range(2):
        s_x, bih = ops["s_x1"][d], ops["bih1"][d]
        _, h = _int8_direction(d, ops["whh1_q"][d], ops["s_h1"][d], ops["bhh1"][d],
                               lambda t, d=d, s_x=s_x, bih=bih: acc[d, t] * s_x + bih,
                               batch, seq_len, tokens.device)
        h_n.append(h)
    return torch.stack(h_n, dim=0).to(dtype)


def input_projection_int8(ys_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """K3's s8 GEMM on its own (the wrapper of the encoder runs it per
    chunk): :func:`input_projection_int8_reference`'s function, int32 out,
    through the TMA + s8 wgmma kernel (``csrc/encoder_hopper.cuh``)."""
    if ys_q.device.type == "cpu":
        return input_projection_int8_reference(ys_q, w_q)
    rows, hidden = _check_projection_args("input_projection_int8", ys_q, w_q, torch.int8)
    w_t = w_q.transpose(1, 2).contiguous()
    out = torch.empty((2, rows, 3 * hidden), dtype=torch.int32, device=ys_q.device)
    check_launch(load_kernels().inpaint_encoder_gemm_int8(
        ys_q.data_ptr(), w_t.data_ptr(), out.data_ptr(), rows, hidden, stream_ptr()),
        "input_projection_int8")
    return out


@counts_launches  # proves a run went through K3
def encoder_hn_int8(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor,
                    max_chunk_rows=None) -> torch.Tensor:
    """K3: ``encoder_hn`` with int8 products (``csrc/encoder_gru_int8.cu``;
    it replaces ``inpaintnet_tpu/ops/encoder_pallas.py
    encoder_hn_pallas_int8``). Same arguments and result as
    :func:`encoder_hn`; the numerics are :func:`encoder_hn_int8_reference`'s.
    On the card it takes the widths the JAX package quantizes
    (``kernel_common.encoder_quantizes``: bf16 masters to H 527, run at 576
    above 512; f32 to 372) and raises on any other."""
    if tokens.device.type == "cpu":
        return encoder_hn_int8_reference(gru_params, emb_table, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"encoder_hn_int8: no kernel for device {tokens.device}")
    hidden = _encoder_hidden("encoder_hn_int8", gru_params)
    masters = gru_params[0][0]["w_hh"].dtype
    if masters in DTYPE_CODES and not encoder_quantizes(hidden, masters):
        raise ValueError(f"encoder_hn_int8: no kernel for hidden size {hidden} in {masters}: "
                         "the JAX package does not quantize it")
    padded = encoder_width(hidden, masters)
    if padded not in (None, hidden):  # zero units: q = 0 at a floored scale, bit-equal at H
        return unpad_units(_encoder_int8_launch(encoder_padded_operands(gru_params)[0],
                                                emb_table, tokens, max_chunk_rows),
                           hidden, padded)
    return _encoder_int8_launch(gru_params, emb_table, tokens, max_chunk_rows)


def _encoder_int8_launch(gru_params, emb_table, tokens, max_chunk_rows):
    """K3's launches at a width its plans take (the wrapper's, or the padded
    one it runs a narrower encoder at)."""
    hidden, dtype, device = _check_encoder_args("encoder_hn_int8", gru_params, emb_table,
                                                tokens)
    batch, seq_len = tokens.shape
    vocab = emb_table.shape[0]
    ops = encoder_int8_operands(gru_params, emb_table)
    # layer 0's input projection dequantized and biased, as the plain version does it
    xtab = (ops["tab_q"].float() * ops["s_x0"][:, None] + ops["bih0"][:, None]).contiguous()
    whh0, whh1 = (torch.stack([pack_gate_slabs(w, 128) for w in ops[k]])
                  for k in ("whh0_q", "whh1_q"))
    wih1_t = ops["wih1_q"].transpose(1, 2).contiguous()
    f32 = {k: ops[k].contiguous() for k in ("s_x0", "s_h0", "s_x1", "s_h1",
                                            "bih0", "bhh0", "bih1", "bhh1")}
    h_n = torch.empty((4, batch, hidden), dtype=dtype, device=device)
    lib = load_kernels()
    consumers = encoder_consumers(hidden, 1)

    def rec(layer, ys, xw, row0, rows):
        args = ((whh0, tokens, xtab, None) if layer == 0 else (whh1, None, None, xw))
        args += tuple(f32[f"{k}{layer}"] for k in ("s_x", "s_h", "bih", "bhh"))
        check_launch(lib.inpaint_encoder_rec_int8(
            DTYPE_CODES[dtype], layer, *(None if a is None else a.data_ptr() for a in args),
            ys.data_ptr(), h_n[2 * layer].data_ptr(), batch, row0, rows, seq_len, hidden,
            vocab, consumers, stream_ptr()), "encoder_hn_int8")

    def gemm(ys, xw, m):
        check_launch(lib.inpaint_encoder_gemm_int8(
            ys.data_ptr(), wih1_t.data_ptr(), xw.data_ptr(), m, hidden, stream_ptr()),
            "encoder_hn_int8")

    chunk = encoder_chunk_rows(batch, seq_len, hidden, max_chunk_rows)
    _encode_chunks(rec, gemm, batch, seq_len, chunk,
                   *_scratch(chunk, seq_len, hidden, torch.int8, torch.int32, device))
    encoder_hn_int8.launches += 1
    return h_n
