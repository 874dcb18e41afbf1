"""Shared pieces for the hand-written CUDA kernels.

- ``round_up``, ``gru_gates_f32`` and ``lstm_gates_f32``: the torch-order
  [r, z, n] GRU and [i, f, g, o] LSTM gate math in f32 (one copy for every
  plain version; the CUDA copies are ``csrc/gru_common.cuh gru_gate`` and
  ``csrc/arnn_decode.cu lstm_gate``).
- The build: ``nvcc`` compiles every ``csrc/*.cu`` (one process per source,
  in parallel) and links them into one shared library with a plain C
  interface, at first use, keyed on the hash of the sources, into
  ``build/inpaintnet_tpu_torch/`` at the repository root. It is loaded
  with ``ctypes``.
- ``pack_mma_b``: the weight layout the ``mma.sync`` kernel reads (K7's
  first kernel; the Hopper kernels' are ``encoder_kernel.pack_gate_slabs``
  / ``pack_gate_blocks``, :func:`split_blocks` and plain transposes).
- ``split_bf16_pieces`` and ``split_product``: the f32 products on the
  tensor cores (the f32 routes of K1, K2, K7 and K8, K5, K6) take each
  operand as three exact bf16 pieces, six passes a 64-wide k-slab added
  slab by slab in f32; ``split_product`` is that arithmetic in plain
  PyTorch, ``split_blocks`` the weight pieces' layout of K7's and K2's.
- The Hopper recurrences of K8, K2 and K4 (``csrc/gru_layer_hopper.cuh``,
  ``csrc/decode_hopper.cuh``): their launch plan (``recurrence_plan``: the
  cluster size and ring depth from the shape and the h tiles' element
  size; K2's and K4's own sizes and boxes above 512 units,
  :func:`decode_cluster_sizes`, :func:`decode_box_halves`,
  :func:`decode_stages`), the CTAs a plan launches (``plan_blocks``), the
  tensor map of K8's packed weights (``slab_map``), and ``WeightCache``,
  which builds such per-weight operands once per weight tensor.
- The widths: K1-K4 take every width up to 512 in both dtypes and, in
  bf16 masters, K1/K3 up to 577 and K2/K4 up to 717
  (:func:`encoder_supports_hidden`, :func:`decode_supports_hidden`; K3 and
  K4 only where the JAX package quantizes, :func:`encoder_quantizes`,
  :func:`decode_quantizes`), K7 up to 512 (:func:`kernel_width`; bf16 up to
  640 and any context width, ``arnn_kernel.arnn_width``), K8 and K5 / K6
  every width (:func:`gru_layer_supports_hidden`); each runs a layer at a
  width its plans take (:func:`encoder_width`, :func:`decode_width`,
  :func:`gru_layer_width`, all over :func:`padded_width`), the units past
  its width zero (:func:`pad_units`, :func:`pad_cell`; ``gate_padding`` is
  the seam where a check plants the gate-major layout).
- Tile groups (K5, K6, K8 above 1024 units): :func:`tile_plan` picks the
  cluster route, a tile group of CTAs that span clusters (as many groups at
  once as the card holds, :func:`card_resident`), or one launch a step;
  ``tile_route`` and ``group_fault`` are the seams where a check forces a
  route or plants a fault of the group's exchange.
- ``check_cuda_tensor``: the wrappers' argument checks.
- ``counts_launches``: the wrappers' ``launches`` counters
  (``LAUNCH_COUNTERS``), which ``graphs.py``'s replays add to as well.
- ``kernel_with_eager_grad``: a kernel route made differentiable by its
  eager twin (``inpaintnet_tpu/ops/pallas_common.py kernel_with_xla_grad``):
  the kernel computes the forward, the backward re-runs the eager twin on
  the saved inputs and differentiates that.

Nothing here imports or builds anything at import time: this module is
imported on machines without ``nvcc`` or a GPU, where only the plain
versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import weakref
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "inpaintnet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def gru_gates_f32(xw, hw, h_prev, hidden: int):
    """Torch-order [r, z, n] GRU gate math in f32, with the products (and
    their biases) precomputed by the caller."""
    r = torch.sigmoid(xw[:, :hidden] + hw[:, :hidden])
    z = torch.sigmoid(xw[:, hidden : 2 * hidden] + hw[:, hidden : 2 * hidden])
    n = torch.tanh(xw[:, 2 * hidden :] + r * hw[:, 2 * hidden :])
    return (1.0 - z) * n + z * h_prev


def lstm_gates_f32(xw, hw, c_prev, hidden: int):
    """Torch-order [i, f, g, o] LSTM gate math in f32, with the products (and
    their biases) precomputed by the caller
    (``inpaintnet_tpu/ops/pallas_common.py lstm_gates_f32``).

    :return: (h_new, c_new)
    """
    gates = xw + hw
    i = torch.sigmoid(gates[:, :hidden])
    f = torch.sigmoid(gates[:, hidden : 2 * hidden])
    g = torch.tanh(gates[:, 2 * hidden : 3 * hidden])
    o = torch.sigmoid(gates[:, 3 * hidden :])
    c_new = f * c_prev + i * g
    return o * torch.tanh(c_new), c_new


def split_bf16_pieces(x: torch.Tensor):
    """(hi, mid, lo): the exact bf16 pieces of ``x`` that the split f32
    products multiply (the f32 routes of K1, K2, K7, K8; K5, K6), hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each difference taken in f32
    (exact). hi + mid + lo is x for a bf16 ``x`` (mid = lo = 0) and within
    2^-24 of |x| for an f32 one (three 8-bit mantissas)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


# The split product's passes: (A piece, W piece) over (hi, mid, lo), the
# smallest terms first (lh, hl, mm, mh, hm, hh); the cross terms left out
# (ll, lm, ml) lie below 2^-24 of |A| |W|
SPLIT_PASSES = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split_blocks(wt_pieces: torch.Tensor, rows: int) -> torch.Tensor:
    """(3, N, K) bf16 pieces of a W^T (N of whole chunks of ``rows`` rows,
    in pairs) as the split recurrences stream them (``csrc/
    gru_layer_hopper.cuh f32_product``): (N / 2 rows pairs of chunks, K / 64
    k-slabs, 3 pieces, 2 chunks, rows, 64) flattened to (rows, 64) blocks,
    so a k-slab of a pair's pieces is six consecutive blocks, one TMA box.
    K7's f32 route takes chunks of 64 rows (16 LSTM units), K2's of 48 (16
    GRU units)."""
    _, n, k = wt_pieces.shape
    return wt_pieces.reshape(3, n // (2 * rows), 2, rows, k // 64, 64) \
        .permute(1, 4, 0, 2, 3, 5).reshape(-1, rows, 64)


def split_product(a: torch.Tensor, w: torch.Tensor, pieces: int = 3) -> torch.Tensor:
    """A plain emulation of the split f32 product ``a @ w`` (the f32 GEMM
    and recurrences of K1, K2, K7 and K8): per 64-wide k-slab, the six passes over the
    bf16 pieces of (M, K) ``a`` and (K, N) ``w`` summed in f32 into a
    partial, the partials added in f32 slab by slab. ``pieces=1`` takes
    ``a`` as its hi piece alone (the planted fault "a product on one bf16
    piece"). The tensor cores' own sum inside a slab is another order, so
    the kernels agree with this within f32 rounding, not bit for bit."""
    pa = split_bf16_pieces(a)
    pw = split_bf16_pieces(w)
    out = None
    for k0 in range(0, a.shape[1], 64):
        part = None
        for i, j in SPLIT_PASSES:
            if i >= pieces:
                continue
            term = pa[i][:, k0:k0 + 64].float() @ pw[j][k0:k0 + 64].float()
            part = term if part is None else part + term
        out = part if out is None else out + part
    return out


# K7's widest layer, and K1-K4's in f32: a row tile in one block's shared memory
KERNEL_MAX_HIDDEN = 512
# K1/K3's and K2/K4's widest layer in bf16 masters (the JAX kernels' VMEM
# gates: ``inpaintnet_tpu/models/measure_vae.py`` ``Encoder._use_pallas``,
# ``HierarchicalDecoder._use_pallas_decode`` at V <= 128), and the widest
# their kernels run one at (on zero units)
ENCODER_MAX_HIDDEN, ENCODER_MAX_WIDTH = 577, 640
DECODE_MAX_HIDDEN, DECODE_MAX_WIDTH = 717, 768
# K5, K6 and K8's widest layer on a cluster of CTAs (16 of 64 units in f32):
# wider layers run on tile groups that span clusters (:func:`tile_plan`)
LAYER_MAX_HIDDEN = 1024


def padded_width(hidden: int, takes, most=None):
    """The width a kernel runs a layer of ``hidden`` units at: the least
    multiple of 64 at or above it, up to ``most`` (None: no ceiling), at
    which the kernel has a plan (``takes(width)``), the units past
    ``hidden`` zero (:func:`pad_units`); None where there is none."""
    if hidden <= 0:
        return None
    top = round_up(hidden, 64) + 64 * 64 if most is None else most
    return next((w for w in range(round_up(hidden, 64), top + 1, 64) if takes(w)), None)


@functools.lru_cache(maxsize=None)
def kernel_width(hidden: int):
    """The width K7 (for H and C) and K1-K4 in f32 masters run ``hidden``
    units at (:func:`padded_width`): whole 64-unit blocks (so every product
    depth is a multiple of the int8 ``mma`` depth of 32, and the bf16 one of
    16), up to 512, a row tile that fits one block's shared memory; None
    above. A wrapper runs a layer whose width this is not on zero units."""
    return padded_width(hidden, lambda w: True, KERNEL_MAX_HIDDEN)


@functools.lru_cache(maxsize=None)
def encoder_width(hidden: int, dtype=None):
    """The width K1 and K3 run ``hidden`` units at in masters of ``dtype``
    (K3 quantizes from them; None: the widths every dtype takes): in f32,
    :func:`kernel_width`; in bf16, whole 64-unit blocks up to 640 (two h
    tiles of 64 x 640 bf16 leave the recurrence block room for two consumer
    warpgroups' rings, ``encoder_kernel.encoder_consumers``), so 577 runs at
    640; None above."""
    if dtype != torch.bfloat16:
        return kernel_width(hidden)
    return padded_width(hidden, lambda w: True, ENCODER_MAX_WIDTH)


@functools.lru_cache(maxsize=None)
def decode_width(hidden: int, dtype=None):
    """The width K2 and K4 run ``hidden`` units at in masters of ``dtype``
    (None: the widths every dtype takes): in f32, :func:`kernel_width`; in
    bf16, the least multiple of 64 up to 768 at which both K2's bf16 route
    and K4 have a plan (:func:`decode_cluster_sizes`, :func:`decode_stages`):
    every one up to 640 (576 on 3 CTAs a tile) and 768 (704's 11 blocks
    split over no portable cluster, so 641-704 run at 768); None above."""
    if dtype != torch.bfloat16:
        return kernel_width(hidden)
    return padded_width(hidden, lambda w: bool(decode_cluster_sizes(w))
                        and decode_stages(w, 2, 2) >= 2 and decode_stages(w, 4, 1) >= 2,
                        DECODE_MAX_WIDTH)


def encoder_supports_hidden(hidden: int, dtype=None) -> bool:
    """K1's and K3's gate in masters of ``dtype`` (None: in either): every
    width up to 512, and in bf16 up to 577 (f32 above 512 runs the eager
    scan), at :func:`encoder_width` on zero units (:func:`pad_units`), which
    computes the narrow layer's function exactly. It is wider than the JAX
    kernel's, which is harmless for K1 (the same function) but not for K3:
    ``quant="int8"`` quantizes only where :func:`encoder_quantizes` also
    holds, and runs K1 elsewhere. K5/K6, K7 and K8 have gates of their own
    (``gru_train_kernel.trainfast_supports``,
    ``arnn_kernel.arnn_kernel_supports``, :func:`gru_layer_supports_hidden`)."""
    most = ENCODER_MAX_HIDDEN if dtype == torch.bfloat16 else KERNEL_MAX_HIDDEN
    return hidden <= most and encoder_width(hidden, dtype) is not None


def decode_supports_hidden(hidden: int, dtype=None) -> bool:
    """K2's and K4's gate in masters of ``dtype`` (None: in either): every
    width up to 512, and in bf16 up to 717 (the JAX kernel's at V <= 128),
    at :func:`decode_width` on zero units. It reads no vocabulary:
    ``quant="int8"`` runs K4 only where :func:`decode_quantizes` also holds,
    and K2 elsewhere."""
    most = DECODE_MAX_HIDDEN if dtype == torch.bfloat16 else KERNEL_MAX_HIDDEN
    return hidden <= most and decode_width(hidden, dtype) is not None


# The JAX kernels' VMEM budget in bytes. The JAX package quantizes only
# inside its kernel branches, which these byte formulas gate; where they
# close, its int8 serving computes in the masters' dtype
JAX_VMEM_BUDGET = 10e6


def encoder_quantizes(hidden: int, dtype) -> bool:
    """Whether ``quant="int8"`` quantizes an encoder of ``hidden`` units in
    masters of ``dtype``, as the JAX package does: its kernel gate's bytes,
    ``18 H^2 x itemsize < 10e6`` (``inpaintnet_tpu/models/measure_vae.py``
    ``Encoder._use_pallas``: both layers' W_ih and W_hh): bf16 up to H 527,
    f32 up to 372."""
    return 18 * hidden * hidden * dtype.itemsize < JAX_VMEM_BUDGET


def decode_quantizes(hidden: int, vocab: int, dtype) -> bool:
    """Whether ``quant="int8"`` quantizes a decoder of ``hidden`` units over
    ``vocab`` tokens in masters of ``dtype``, as the JAX package does: its
    kernel gate's bytes, ``(9 H^2 + 4 H Vp) x itemsize < 10e6`` with Vp the
    vocabulary padded to 128 (``HierarchicalDecoder._use_pallas_decode``):
    at V <= 128 bf16 up to H 717 and f32 up to 499."""
    vocab_pad = round_up(vocab, 128)
    return (9 * hidden * hidden + 4 * hidden * vocab_pad) * dtype.itemsize < JAX_VMEM_BUDGET


@functools.lru_cache(maxsize=None)
def gru_layer_width(hidden: int, dtype=torch.float32):
    """The width K8 (``csrc/gru_layer.cu``) runs ``hidden`` units at
    (:func:`padded_width`). Up to 1024 its f32 route takes H / 64 CTAs of
    64 units, up to 16: every multiple of 64; its bf16 route splits the
    units across a cluster whose CTAs own whole 64-unit blocks, at most 512
    units each (:func:`cluster_sizes`), so above 512 the number of blocks
    must be even: 576 and 640 run at 640, 704 at 768. Above 1024 it runs on
    tile groups of :func:`tile_units` CTAs: every multiple of 64 in f32, of
    128 in bf16 (1088 runs at 1152)."""
    def takes(w):
        if w > LAYER_MAX_HIDDEN:
            return w % tile_units(dtype) == 0
        return dtype != torch.bfloat16 or bool(cluster_sizes(w))
    return padded_width(hidden, takes)


def gru_layer_supports_hidden(hidden: int, dtype=torch.float32) -> bool:
    """Hidden widths K8 takes: every width, at :func:`gru_layer_width`
    (the JAX package's K8 has no width gate)."""
    return gru_layer_width(hidden, dtype) is not None


# --------------------------------------------------------------------------- #
# Tile groups: the CTAs of a 64-row tile beyond one cluster (K5, K6, K8)
# --------------------------------------------------------------------------- #
class TilePlan(NamedTuple):
    """How K5, K6 or K8 runs a layer: ``route`` "cluster" (the CTAs of a
    tile form a cluster and meet at an mbarrier), "group" (``ctas`` CTAs a
    tile meet at a counter in global memory, ``groups`` tile groups run at
    once, each walking the tiles i, i + groups, ...) or "step" (one launch
    a step, the launch boundary the barrier, for a group the card cannot
    hold at once; ``groups``: every tile)."""
    route: str
    ctas: int
    groups: int


SYNC_CODES = {"group": 1, "step": 2}  # csrc/hopper_common.cuh TileSync


def tile_units(dtype, kernel: str = "K8") -> int:
    """Units a CTA owns on a tile group: K5's and K8's register budget, 64
    in f32 (the sum and a k-slab's partial of a 32-unit chunk) and 128 in
    bf16; K6's 128 in both dtypes."""
    return 128 if kernel == "K6" or dtype == torch.bfloat16 else 64


def tile_route():
    """The route every K5, K6 and K8 launch takes: None, the plan's own
    (the cluster route up to 1024 units, tile groups above); a check forces
    "group" or "step" here at any width (one place, as
    :func:`gate_padding`)."""
    return None


def group_fault() -> int:
    """The planted fault of a tile group's exchange passed to every
    tile-group launch (``csrc/hopper_common.cuh GroupFault``): 0, none. A
    check plants 1 (a consumer reads the other parity buffer's pieces) or 2
    (it waits for one arrival fewer than the group's CTAs, the last CTA
    paused), which the kernels' bounds must reject."""
    return 0


def tile_plan(rows: int, hidden: int, dtype, sms: int = 132, resident=None,
              kernel: str = "K8", route=None) -> TilePlan:
    """The route of K5, K6 or K8 (``kernel``) at ``rows`` rows of
    ``hidden`` units (a multiple of :func:`tile_units`) on a card of ``sms``
    SMs holding ``resident`` of the kernel's CTAs at once (default one an
    SM: each takes most of an SM's shared memory; the wrappers ask the
    occupancy API): up to 1024 units the cluster route, above it a tile
    group of ``hidden / units`` CTAs, with as many groups at once as the
    card holds (at most the tiles), and where one group is more than the
    card holds, one launch a step. ``route`` forces "group" or "step" (the
    cluster route is the plan's own up to 1024 units and no further: a
    cluster of 12 at 1536 units ran slower than the group route)."""
    if route not in (None, "group", "step"):
        raise ValueError(f"{kernel}: no forced route {route!r} (group or step)")
    resident = sms if resident is None else resident
    ctas, tiles = hidden // tile_units(dtype, kernel), -(-rows // HOPPER_ROWS)
    route = route or ("cluster" if hidden <= LAYER_MAX_HIDDEN
                      else "group" if ctas <= resident else "step")
    if route == "group":
        if ctas > resident:
            raise ValueError(f"{kernel}: a group of {ctas} CTAs is more than the {resident} "
                             "the card holds at once")
        return TilePlan(route, ctas, min(tiles, resident // ctas))
    return TilePlan(route, ctas, tiles)


@functools.lru_cache(maxsize=None)
def card_resident(entry: str, dtype_code: int, stages: int, device_index: int) -> int:
    """CTAs of a tile-group kernel the card holds at once, from its
    library entry point (``inpaint_gru_fwd_resident``,
    ``inpaint_gru_layer_resident``, ``inpaint_gru_bwd_resident``), asked
    once per card."""
    with torch.cuda.device(device_index):
        n = getattr(load_kernels(), entry)(dtype_code, stages)
    if n < 1:
        raise RuntimeError(f"{entry}: the card holds no CTA of dtype {dtype_code} with "
                           f"{stages} stages")
    return n


def card_tile_plan(rows: int, hidden: int, dtype, kernel: str, entry: str, stages: int,
                   device):
    """:func:`tile_plan` on the card ``device`` names, or None where the
    cluster route runs unforced (up to 1024 units): the plan a wrapper of
    K5 (``entry`` ``inpaint_gru_fwd_resident``), K6 or K8 launches on tile
    groups. Raises ValueError for a width that is not whole CTAs."""
    route = tile_route()
    if route is None and hidden <= LAYER_MAX_HIDDEN:
        return None
    units = tile_units(dtype, kernel)
    if hidden % units:
        raise ValueError(f"{kernel}: no tile-group plan for hidden size {hidden} in {dtype} "
                         f"({units} units a CTA)")
    index = device.index if device.index is not None else torch.cuda.current_device()
    resident = card_resident(entry, DTYPE_CODES[dtype], stages, index)
    return tile_plan(rows, hidden, dtype, torch.cuda.get_device_properties(index)
                     .multi_processor_count, resident, kernel, route)


def tile_scratch(plan: TilePlan, rows: int, hidden: int, device) -> tuple:
    """(counters, carry) of a tile-group launch: the tiles' arrival
    counters, zeros (route "group"), or h between launches, (rows, hidden)
    f32 (route "step"); None where the route takes none."""
    counters = (torch.zeros((-(-rows // HOPPER_ROWS),), dtype=torch.int32, device=device)
                if plan.route == "group" else None)
    carry = (torch.empty((rows, hidden), dtype=torch.float32, device=device)
             if plan.route == "step" else None)
    return counters, carry


def data_ptr(t) -> int:
    """A tensor's address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


# --------------------------------------------------------------------------- #
# Zero units: a layer of any width on kernels that tile 64-unit blocks
# --------------------------------------------------------------------------- #
def gate_padding() -> int:
    """How :func:`pad_units` lays a layer's gates out at the padded width:
    0, gate by gate (gate g of the real layer at columns [g Hp, g Hp + H)),
    the one layout that computes the narrow layer's function. The wrappers
    all pad through here, so a check can plant 1: the 3H (4H) columns
    padded as a whole at the end, which hands every gate past the first
    another gate's columns (:func:`padded_cache` keys its operands on it)."""
    return 0


def _unit_groups(groups: int, hidden: int, padded: int) -> tuple:
    if groups > 1 and gate_padding():
        return 1, groups * hidden, groups * padded
    return groups, hidden, padded


def pad_units(t: torch.Tensor, hidden: int, padded: int, groups: int = 1,
              dim: int = -1) -> torch.Tensor:
    """``t`` with each of its ``groups`` blocks of ``hidden`` entries along
    ``dim`` zero-padded to ``padded``: a hidden state (1), a layer's gate
    columns (3 for a GRU, 4 for an LSTM), the input rows of a layer that
    reads a padded one (2 for a bidirectional layer's [forward | backward]
    concat). The wrappers of K1-K8 build their padded operands through it."""
    if padded == hidden:
        return t
    dim %= t.dim()
    groups, hidden, padded = _unit_groups(groups, hidden, padded)
    blocks = t.unflatten(dim, (groups, hidden))
    zeros = blocks.new_zeros((*blocks.shape[:dim + 1], padded - hidden, *blocks.shape[dim + 2:]))
    return torch.cat([blocks, zeros], dim + 1).flatten(dim, dim + 1)


def unpad_units(t: torch.Tensor, hidden: int, padded: int, groups: int = 1,
                dim: int = -1) -> torch.Tensor:
    """The inverse of :func:`pad_units`: each block's first ``hidden``
    entries, contiguous."""
    if padded == hidden:
        return t
    dim %= t.dim()
    groups, hidden, padded = _unit_groups(groups, hidden, padded)
    return t.unflatten(dim, (groups, padded)).narrow(dim + 1, 0, hidden) \
        .flatten(dim, dim + 1).contiguous()


CELL_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")  # a GRU or LSTM cell's weights, in this order


def pad_cell(p: dict, hidden: int, padded: int, gates: int, rows=None) -> dict:
    """A GRU (``gates`` 3) or LSTM (4) cell's {w_ih, w_hh, b_ih, b_hh} at
    ``padded`` units: every weight's and bias's gate columns zero-padded
    gate by gate, W_hh's rows too, and W_ih's rows by ``rows`` where the
    cell reads a padded input. Exact: a padded GRU unit (zero weights and
    biases, h0 0) sees r = z = 1/2 and n = tanh(0) = 0, so h' = h / 2 stays
    0; a padded LSTM unit sees g = 0, so c and h = o tanh(c) stay 0; and
    their zero rows of W_hh and of the next layer's W_ih feed nothing into
    the real units."""
    def cols(t):
        return pad_units(t, hidden, padded, gates)
    w_ih = cols(p["w_ih"])
    return {"w_ih": w_ih if rows is None else rows(w_ih),
            "w_hh": pad_units(cols(p["w_hh"]), hidden, padded, dim=0),
            "b_ih": cols(p["b_ih"]), "b_hh": cols(p["b_hh"])}


# --------------------------------------------------------------------------- #
# The Hopper recurrences of K8, K2 and K4 (csrc/gru_layer_hopper.cuh)
# --------------------------------------------------------------------------- #
HOPPER_ROWS = 64  # rows of a CTA: one wgmma tile
HOPPER_CLUSTERS = (1, 2, 4, 8)  # the cluster sizes the plans prefer
# the other portable sizes (up to 8 CTAs), which a plan takes only where no
# power of two fits: a width of 5 or 7 blocks of 64 splits evenly only so
HOPPER_ODD_CLUSTERS = (3, 5, 6, 7)
# the non-portable sizes an H100 takes (its launch sets
# cudaFuncAttributeNonPortableClusterSizeAllowed), for a plan that asks for
# them where no portable size fits (K7 bf16 at H 576 and 640)
HOPPER_WIDE_CLUSTERS = tuple(range(9, 17))
HOPPER_MAX_UNITS = 512  # units a CTA computes: 2 consumer warpgroups x 8 chunks of 32
HOPPER_SLAB_ROWS = 96  # one k-slab of a chunk: its r, z, n rows x 64 of K
HOPPER_CONSUMERS = 2
HOPPER_MAX_STAGES = 6
HOPPER_SMEM_BUDGET = 232448 - 2048  # the 227 KB opt-in less alignment and barriers


class LaunchPlan(NamedTuple):
    """How a Hopper recurrence runs a shape: ``cluster`` CTAs share each
    64-row tile, each computing ``hidden / cluster`` units, and each
    consumer warpgroup's TMA ring has ``stages`` stages."""
    cluster: int
    stages: int


def fitting_clusters(fits, wide: bool = False) -> list:
    """The sizes of ``HOPPER_CLUSTERS`` for which ``fits(c)`` holds, or,
    where none does, those of ``HOPPER_ODD_CLUSTERS``, or, where none of
    those does either and ``wide`` asks for them, those of
    ``HOPPER_WIDE_CLUSTERS``."""
    return ([c for c in HOPPER_CLUSTERS if fits(c)]
            or [c for c in HOPPER_ODD_CLUSTERS if fits(c)]
            or [c for c in HOPPER_WIDE_CLUSTERS if wide and fits(c)])


def head_ties() -> int:
    """How the heads' argmax over chunks (K2, K4 and K7, ``csrc/
    gru_layer_hopper.cuh``) breaks a tie between two vocabulary chunks: 0,
    the lower index, so the first index among equal maxima wins across
    chunks as the plain versions' ``argmax`` does. The wrappers pass it to
    every launch (one place, so a check can plant 1, "a later chunk wins a
    tie": each thread walks its chunks last to first, and the warpgroups'
    merge prefers the later chunk)."""
    return 0


def cluster_sizes(hidden: int) -> list:
    """Cluster sizes that split ``hidden`` units into whole 64-unit blocks
    of at most ``HOPPER_MAX_UNITS`` units a CTA."""
    blocks = hidden // 64
    return [c for c in HOPPER_CLUSTERS
            if hidden % 64 == 0 and blocks % c == 0 and hidden // c <= HOPPER_MAX_UNITS]


def decode_cluster_sizes(hidden: int) -> list:
    """K2's and K4's cluster sizes (``csrc/decode_hopper.cuh
    decode_plan_fits``): :func:`cluster_sizes`, or where no power of two
    splits the width, the odd portable sizes that do
    (:func:`fitting_clusters`): 3 at H 576. The same as
    :func:`cluster_sizes` up to 512 units (one CTA takes them all)."""
    if hidden % 64 or hidden <= 0:
        return []
    return fitting_clusters(lambda c: (hidden // 64) % c == 0 and hidden // c <= HOPPER_MAX_UNITS)


def box_slabs(hidden: int) -> int:
    """k-slabs a TMA box and a ring stage hold (``gru_layer_hopper.cuh
    box_slabs``): 2 where the 64-unit blocks pair up, else 1 (bf16 slabs of
    12 KB and K4's int8 ones of 6 KB alike)."""
    return 2 if (hidden // 64) % 2 == 0 else 1


def ring_stages(hidden: int, h_tiles: int, elem_bytes: int = 2) -> int:
    """Ring stages a consumer warpgroup gets beside ``h_tiles`` 64-row h
    tiles of ``elem_bytes`` a value (``gru_layer_hopper.cuh smem_bytes``; a
    k-slab row holds 64 values of K in either type): 3 at H 512 with one
    bf16 tile, 2 at H 1024 with one or at H 512 with two; 4 at H 512 with
    K4's four int8 tiles (12 KB boxes)."""
    free = HOPPER_SMEM_BUDGET - 1024 - h_tiles * HOPPER_ROWS * hidden * elem_bytes
    stage = box_slabs(hidden) * HOPPER_SLAB_ROWS * 64 * elem_bytes
    return min(HOPPER_MAX_STAGES, free // (HOPPER_CONSUMERS * stage))


def decode_box_halves(hidden: int, h_tiles: int, elem_bytes: int) -> int:
    """Halves of a 64-value k-slab that a K2 / K4 TMA box and ring stage
    hold beside ``h_tiles`` h tiles (``csrc/decode_hopper.cuh
    decode_box_halves``): 2 :func:`box_slabs` where two stages of them fit,
    else one slab (2), else in bf16 half of one (1; 32 values with the
    64-byte swizzle); 0 where none fits. Up to H 512, 2 box_slabs: K2 at 640
    takes one slab, at 768 half of one; K4 at 768 one."""
    free = HOPPER_SMEM_BUDGET - 1024 - h_tiles * HOPPER_ROWS * hidden * elem_bytes
    options = (2 * box_slabs(hidden), 2) + ((1,) if elem_bytes == 2 else ())
    return next((kh for kh in options
                 if free >= 2 * HOPPER_CONSUMERS * kh * HOPPER_SLAB_ROWS * 64 * elem_bytes // 2),
                0)


def decode_stages(hidden: int, h_tiles: int, elem_bytes: int) -> int:
    """Ring stages of a K2 (2 bf16 tiles) or K4 (4 int8 tiles) consumer
    warpgroup of :func:`decode_box_halves` boxes: :func:`ring_stages` up to
    H 512; 3 for K2 at 576, 2 at 640 and 768; 6, 2 and 2 for K4. 0 where no
    box fits."""
    halves = decode_box_halves(hidden, h_tiles, elem_bytes)
    if not halves:
        return 0
    free = HOPPER_SMEM_BUDGET - 1024 - h_tiles * HOPPER_ROWS * hidden * elem_bytes
    stage = halves * HOPPER_SLAB_ROWS * 64 * elem_bytes // 2
    return min(HOPPER_MAX_STAGES, free // (HOPPER_CONSUMERS * stage))


def decode_smem_bytes(hidden: int, h_tiles: int, elem_bytes: int, stages: int) -> int:
    """Dynamic shared memory of a K2 / K4 CTA (``csrc/decode_hopper.cuh
    decode_smem_bytes``): its h tiles and the rings."""
    halves = decode_box_halves(hidden, h_tiles, elem_bytes)
    return (h_tiles * HOPPER_ROWS * hidden * elem_bytes
            + HOPPER_CONSUMERS * stages * halves * HOPPER_SLAB_ROWS * 64 * elem_bytes // 2 + 1024)


HOPPER_CTA_OVERHEAD = 0.02  # a CTA's fixed share of a wave, in tiles' work (see below)


def least_cost_cluster(rows: int, sizes: list, sms: int, slots=None) -> int:
    """The cluster size C of ``sizes`` with the least modelled time: waves
    of clusters, ``ceil(tiles / slots[C])``, each as long as 1/C of a tile's
    units plus a fixed share ``HOPPER_CTA_OVERHEAD`` that every CTA pays
    whatever its units (its prologue, the per-step exchange); the smaller C
    on a tie. ``slots[C]``: the clusters of C CTAs the card runs at once
    (the kernels' ``*_slots`` entry points ask the CUDA runtime), by default
    ``sms // C``."""
    slots = slots or {c: max(1, sms // c) for c in sizes}
    tiles = -(-rows // HOPPER_ROWS)

    def cost(c):
        return -(-tiles // slots[c]) * (1 / c + HOPPER_CTA_OVERHEAD)
    return min(sizes, key=lambda c: (cost(c), c))


def recurrence_plan(rows: int, hidden: int, sms: int, h_tiles: int, slots=None) -> LaunchPlan:
    """The cluster size of :func:`least_cost_cluster` among
    :func:`cluster_sizes` (an H100 runs 30 clusters of 4 and 15 of 8), with
    the ring depth beside ``h_tiles`` h tiles. With the default slots on 132
    SMs at H 512: 1 or 6 rows take 8, 2,048 rows (32 tiles) 4, 12,288 rows
    (192 tiles) 2, 65,536 rows 1; with an H100's own slots 2,048 rows take
    8 (three waves of 1/8 of a tile beat two of 1/4). Raises ValueError for
    a width no cluster size splits."""
    sizes = cluster_sizes(hidden)
    stages = ring_stages(hidden, h_tiles)
    if not sizes or stages < 2:
        raise ValueError(f"no Hopper recurrence plan for hidden size {hidden}")
    return LaunchPlan(least_cost_cluster(rows, sizes, sms, slots), stages)


@functools.lru_cache(maxsize=None)
def recurrence_slots(entry: str, hidden: int, stages: int, device_index: int,
                     sizes: tuple = None) -> dict:
    """{C: clusters of C CTAs the card runs at once} for the Hopper
    recurrence whose kernel library entry point is ``entry``
    (``inpaint_gru_layer_slots`` or ``inpaint_decode_slots``), for each C of
    ``sizes`` (default :func:`cluster_sizes`), asked once per width and
    card."""
    with torch.cuda.device(device_index):
        counts = {c: getattr(load_kernels(), entry)(hidden, c, stages)
                  for c in sizes or cluster_sizes(hidden)}
    bad = {c: n for c, n in counts.items() if n < 1}
    if bad:
        raise RuntimeError(f"{entry}: the card runs no cluster of sizes {sorted(bad)} "
                           f"at hidden size {hidden}")
    return counts


def plan_blocks(rows: int, hidden: int, plan: LaunchPlan) -> list:
    """The (row0, row1, unit0, unit1) each CTA of a launch computes, in
    ``blockIdx.x`` order: CTA x is rank ``x % C`` of the cluster of row tile
    ``x // C`` (the kernels' own index math)."""
    c = plan.cluster
    units = hidden // c
    return [(t * HOPPER_ROWS, min((t + 1) * HOPPER_ROWS, rows), r * units, (r + 1) * units)
            for t in range(-(-rows // HOPPER_ROWS)) for r in range(c)]


def slab_map(packed: torch.Tensor):
    """The tensor map (a 128-byte CUtensorMap, in a host buffer) of K8's
    packed (chunks, H / 64, 96, 64) bf16 gate blocks (``encoder_kernel.
    pack_gate_blocks``), ``box_slabs`` k-slabs a box with the 128-byte
    swizzle (K2's and K4's: ``decode_kernel.slab_map``). Keep ``packed``
    alive as long as the map."""
    buf = ctypes.create_string_buffer(128 + 64)
    addr = (ctypes.addressof(buf) + 63) // 64 * 64
    blocks = packed.shape[0] * packed.shape[1]
    check_launch(load_kernels().inpaint_slab_map(packed.data_ptr(), blocks, packed.shape[1] * 64,
                                                 addr), "slab_map")
    return buf, addr


def _version(t: torch.Tensor):
    try:
        return t._version
    except RuntimeError:  # an inference tensor counts no versions
        return None


class WeightCache:
    """Operands built from weight tensors once: ``cache(*weights,
    **static)`` returns ``build(*weights, **static)``, rebuilt when any
    weight is another tensor (weak references, not reused ids) or was
    updated in place (its ``_version`` moved); ``static`` (hashable: a
    width, a layout) is part of the key. Inference tensors count no
    versions, so they are rebuilt every call.

    A build inside a CUDA graph capture raises: its operands would be
    computed only when the graph replays, and an eager call that hit them
    before that would read memory nothing has written (``graphs.py`` runs
    each call once outside the capture first)."""

    def __init__(self, build):
        self._build = build
        self._entries = {}

    def __call__(self, *weights, **static):
        key = tuple(id(w) for w in weights) + tuple(sorted(static.items()))
        stamp = tuple(_version(w) for w in weights)
        hit = self._entries.get(key)
        if (hit is not None and None not in stamp and hit[1] == stamp
                and all(ref() is w for ref, w in zip(hit[0], weights))):
            return hit[2]
        if weights[0].is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{getattr(self._build, '__name__', 'WeightCache')}: weight "
                               "operands built inside a CUDA graph capture; run the call once "
                               "before capturing it")
        ops = self._build(*weights, **static)
        self._entries = {k: v for k, v in self._entries.items()
                         if all(ref() is not None for ref in v[0])}
        self._entries[key] = ([weakref.ref(w) for w in weights], stamp, ops)
        return ops


def padded_cache(build):
    """A :class:`WeightCache` of weights with zero units: ``cache(*weights,
    padded=width)`` returns ``build(*weights, padded=width)``, keyed also on
    the width and on :func:`gate_padding`, so a planted layout builds
    operands of its own.

    The padded weights are built as ordinary tensors outside autograd, even
    under ``torch.inference_mode`` (an engine's or a tester's first call):
    they count versions, so the kernels' own caches of operands built from
    them hit on every later call, a CUDA graph capture included."""
    def versioned(*weights, layout, **widths):
        with torch.inference_mode(False), torch.no_grad():
            return build(*weights, **widths)
    cache = WeightCache(versioned)
    return lambda *weights, **widths: cache(*weights, layout=gate_padding(), **widths)


def _pad_gru_layer(w_hh: torch.Tensor, *bias: torch.Tensor, padded: int) -> tuple:
    hidden = w_hh.shape[0]
    return (pad_units(pad_units(w_hh, hidden, padded, 3), hidden, padded, dim=0),
            *(pad_units(b, hidden, padded, 3) for b in bias))


# (W_hh, b_hh ...) of one GRU layer direction with zero units, built once
# per weight tensor and width: K8's, K5's and K6's (W_hh alone) operands
padded_gru_layer = padded_cache(_pad_gru_layer)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
                       "kernels cannot be built")


def _run_all(cmds, verbose: bool) -> None:
    """Run the commands at once, wait for all of them, and raise on the
    first that failed (printing every output when ``verbose``)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}")


def build_kernels(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``libkernels_<hash>.so`` unless a library
    of the same sources exists: one ``nvcc -c`` per source, all started
    together, then one link. Returns its path; raises on a failed build."""
    lib = BUILD_DIR / f"libkernels_{sources_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]
        _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                   "-o", obj, str(src)]
                  for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)], verbose)
        so = str(Path(tmp) / lib.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]], verbose)
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's ``argtypes`` set (an unset one would pass pointers as 32-bit
    ints)."""
    lib = ctypes.CDLL(str(build_kernels()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.c_float
    lib.inpaint_encoder_rec_f32.argtypes = [i32] + [ptr] * 9 + [i32] * 8 + [f32, ptr]
    lib.inpaint_encoder_rec_f32.restype = i32
    lib.inpaint_encoder_w_map_f32.argtypes = [ptr, i32, i32, ptr]
    lib.inpaint_encoder_w_map_f32.restype = i32
    lib.inpaint_encoder_gemm_f32.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    lib.inpaint_encoder_gemm_f32.restype = i32
    lib.inpaint_encoder_rec_bf16.argtypes = [i32] + [ptr] * 9 + [i32] * 7 + [f32, ptr]
    lib.inpaint_encoder_rec_bf16.restype = i32
    lib.inpaint_encoder_gemm_bf16.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    lib.inpaint_encoder_gemm_bf16.restype = i32
    lib.inpaint_decode_sampling_f32.argtypes = [ptr] * 12 + [i32] * 6 + [ptr]
    lib.inpaint_decode_sampling_f32.restype = i32
    lib.inpaint_decode_f32_map.argtypes = [ptr, i32, ptr]
    lib.inpaint_decode_f32_map.restype = i32
    lib.inpaint_decode_f32_slots.argtypes = [i32] * 3
    lib.inpaint_decode_f32_slots.restype = i32
    lib.inpaint_gru_layer_f32_slots.argtypes = [i32] * 3
    lib.inpaint_gru_layer_f32_slots.restype = i32
    lib.inpaint_decode_sampling_bf16.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.inpaint_decode_sampling_bf16.restype = i32
    lib.inpaint_slab_map.argtypes = [ptr, i32, i32, ptr]
    lib.inpaint_slab_map.restype = i32
    lib.inpaint_gru_layer_slots.argtypes = [i32] * 3
    lib.inpaint_gru_layer_slots.restype = i32
    lib.inpaint_decode_slots.argtypes = [i32] * 3
    lib.inpaint_decode_slots.restype = i32
    lib.inpaint_encoder_rec_int8.argtypes = [i32] * 2 + [ptr] * 10 + [i32] * 7 + [ptr]
    lib.inpaint_encoder_rec_int8.restype = i32
    lib.inpaint_encoder_gemm_int8.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    lib.inpaint_encoder_gemm_int8.restype = i32
    lib.inpaint_decode_sampling_int8.argtypes = [i32] + [ptr] * 13 + [i32] * 6 + [ptr]
    lib.inpaint_decode_sampling_int8.restype = i32
    lib.inpaint_decode_map.argtypes = [ptr, i32, i32, i32, ptr]
    lib.inpaint_decode_map.restype = i32
    lib.inpaint_gru_fwd_hopper.argtypes = [i32] + [ptr] * 6 + [i32] * 6 + [ptr]
    lib.inpaint_gru_fwd_hopper.restype = i32
    lib.inpaint_gru_fwd_w_map.argtypes = [ptr] + [i32] * 3 + [ptr]
    lib.inpaint_gru_fwd_w_map.restype = i32
    lib.inpaint_gru_bwd_hopper.argtypes = [i32] + [ptr] * 11 + [i32] * 6 + [ptr]
    lib.inpaint_gru_bwd_hopper.restype = i32
    lib.inpaint_gru_bwd_w_map.argtypes = [ptr] + [i32] * 3 + [ptr]
    lib.inpaint_gru_bwd_w_map.restype = i32
    lib.inpaint_arnn_decode.argtypes = [i32] + [ptr] * 16 + [i32] * 7 + [ptr]
    lib.inpaint_arnn_decode.restype = i32
    lib.inpaint_arnn_decode_bf16.argtypes = [ptr] * 11 + [i32] * 11 + [ptr]
    lib.inpaint_arnn_decode_bf16.restype = i32
    lib.inpaint_arnn_map.argtypes = [ptr, i32, i32, ptr]
    lib.inpaint_arnn_map.restype = i32
    lib.inpaint_arnn_slots.argtypes = [i32] * 5
    lib.inpaint_arnn_slots.restype = i32
    lib.inpaint_arnn_ctx_gemm.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.inpaint_arnn_ctx_gemm.restype = i32
    lib.inpaint_arnn_decode_f32.argtypes = [ptr] * 12 + [i32] * 7 + [ptr]
    lib.inpaint_arnn_decode_f32.restype = i32
    lib.inpaint_arnn_f32_map.argtypes = [ptr, i32, ptr]
    lib.inpaint_arnn_f32_map.restype = i32
    lib.inpaint_arnn_f32_slots.argtypes = [i32] * 3
    lib.inpaint_arnn_f32_slots.restype = i32
    lib.inpaint_arnn_ctx_gemm_f32.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.inpaint_arnn_ctx_gemm_f32.restype = i32
    lib.inpaint_gru_layer_f32.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.inpaint_gru_layer_f32.restype = i32
    lib.inpaint_gru_layer_bf16.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.inpaint_gru_layer_bf16.restype = i32
    lib.inpaint_gru_fwd_tiles.argtypes = [i32] + [ptr] * 8 + [i32] * 9 + [ptr]
    lib.inpaint_gru_fwd_tiles.restype = i32
    lib.inpaint_gru_layer_tiles.argtypes = [i32] + [ptr] * 10 + [i32] * 9 + [ptr]
    lib.inpaint_gru_layer_tiles.restype = i32
    lib.inpaint_gru_bwd_tiles.argtypes = [i32] + [ptr] * 13 + [i32] * 9 + [ptr]
    lib.inpaint_gru_bwd_tiles.restype = i32
    for entry in ("inpaint_gru_fwd_resident", "inpaint_gru_layer_resident",
                  "inpaint_gru_bwd_resident"):
        getattr(lib, entry).argtypes = [i32] * 2
        getattr(lib, entry).restype = i32
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` from a C entry point: a refused
    launch never runs, and a later synchronise would not report it."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


# The kernel wrappers whose ``launches`` counters prove a run went through
# their kernels (:func:`counts_launches`)
LAUNCH_COUNTERS: list = []


def counts_launches(wrapper):
    """Give a kernel wrapper its ``launches`` counter, 0 at import: the
    wrapper adds one where it launches its kernel on the card (never on the
    CPU), and a CUDA graph replay adds the launches its capture counted
    (``graphs.py``). The wrapper is registered in ``LAUNCH_COUNTERS``."""
    wrapper.launches = 0
    LAUNCH_COUNTERS.append(wrapper)
    return wrapper


def check_cuda_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust all four."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _flatten(tree, leaves: list):
    """The structure of nested dicts, lists and tuples ``tree``, its tensor
    leaves appended to ``leaves`` (anything else is kept as a constant)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("leaf", len(leaves) - 1)
    return ("const", tree)


def _unflatten(spec, leaves):
    kind, body = spec
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in body}
    if kind == "leaf":
        return leaves[body]
    if kind == "const":
        return body
    return kind(_unflatten(v, leaves) for v in body)


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class _EagerGrad(torch.autograd.Function):
    """The forward of ``kernel_fn`` with the gradient of ``eager_fn`` at the
    same inputs (:func:`kernel_with_eager_grad`). The arguments' tensors
    come in flattened (``spec`` rebuilds the nesting); the inputs are saved
    and the backward recomputes the eager twin from them (remat, as JAX's
    residuals)."""

    @staticmethod
    def forward(ctx, kernel_fn, eager_fn, spec, *leaves):
        out = kernel_fn(*_unflatten(spec, leaves))
        ctx.eager_fn, ctx.spec = eager_fn, spec
        ctx.save_for_backward(*leaves)
        ctx.mark_non_differentiable(*(o for o in _outputs(out) if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = _outputs(ctx.eager_fn(*_unflatten(ctx.spec, inputs)))
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wanted = [x for x, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wanted else [None] * len(wanted))
        return (None, None, None, *(next(got) if n else None for n in need))


def kernel_with_eager_grad(kernel_fn, eager_fn):
    """``kernel_fn`` made differentiable (the port's ``inpaintnet_tpu/ops/
    pallas_common.py kernel_with_xla_grad``): where autograd records and
    some argument tensor requires a gradient, the forward runs
    ``kernel_fn`` on the inputs with no graph, and the backward re-runs
    ``eager_fn`` (the same positional arguments, the same outputs) on them
    under ``enable_grad`` and returns its gradients with the incoming
    cotangents. The arguments may nest tensors in dicts, lists and tuples;
    a leaf that needs no gradient gets none; integer outputs (samples,
    tokens) are not differentiable. Elsewhere it is ``kernel_fn`` itself, so
    inference launches what it launched before."""
    def run(*args):
        leaves = []
        spec = _flatten(args, leaves)
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in leaves)):
            return kernel_fn(*args)
        return _EagerGrad.apply(kernel_fn, eager_fn, spec, *leaves)
    return run


def pack_mma_b(w: torch.Tensor) -> torch.Tensor:
    """Reorder a (K, N) bf16 weight into the ``mma.sync m16n8k16`` B-fragment
    order the kernels load (``gru_common.cuh Gemm``): for each 8-column tile
    and 16-row k-tile, lane ``l = 4 * r + q`` holds
    ``w[k0 + 2q + {0, 1, 8, 9}, n0 + r]`` as four contiguous values.
    f32 weights stay (K, N): the f32 route reads them as they are."""
    if w.dtype != torch.bfloat16:
        return w.contiguous()
    K, N = w.shape
    if K % 16 or N % 8:
        raise ValueError(f"pack_mma_b: shape {(K, N)} needs K % 16 == 0 and N % 8 == 0")
    # k = kt*16 + half*8 + q*2 + p ; n = nt*8 + r  ->  (nt, kt, r, q, half, p)
    return w.reshape(K // 16, 2, 4, 2, N // 8, 8).permute(4, 0, 5, 2, 1, 3).contiguous()
