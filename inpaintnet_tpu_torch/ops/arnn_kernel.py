"""K7: the AnticipationRNN's argmax decode with forced ticks.

``arnn_sampled_decode`` is the CUDA kernel ``csrc/arnn_decode.cu`` (it
replaces the TPU kernel ``inpaintnet_tpu/ops/arnn_pallas.py
arnn_sampled_decode_pallas``; the source says what bounds it on the card
and how its design answers). ``arnn_sampled_decode_reference`` is its
plain PyTorch version with the TPU kernel's numerics, per tick:

- layer 0's input projection is ``prev_xw + ctx_t @ W_ctx + b_ih0``, where
  ``prev_xw`` is a row of the parameter-dtype token table ``emb @ W_ih0[:E]``
  (``start_xw`` at t = 0) and the context product lies inside the loop;
- products accumulate in f32, biases and gates are f32, and both layers' h
  AND c are rounded to the parameter dtype after every tick;
- the head is ``relu(h1 @ W_l1 + b_l1)`` rounded to the parameter dtype,
  then ``@ W_out + b_out``: unbounded f32 logits, written in the parameter
  dtype; the argmax runs over the V real columns and takes the first index
  among equal maxima;
- where ``force_mask > 0`` the ground-truth token replaces the sampled one,
  as the output and as the next tick's feedback.

The operands around the loop (token table, tick-0 input, the split of
W_ih0, the bias stack) are computed outside the kernel by
``arnn_decode_inputs``, as the TPU kernel's are.

The bf16 route is the Hopper design of ``csrc/arnn_hopper.cuh``: the
context product of every tick runs first, as one GEMM into f32 rows
(:func:`ctx_projection`; the recurrence adds a tick's row in the plain
version's order, and :func:`arnn_sampled_decode_staged_reference` is that
staging in plain PyTorch), then a cluster recurrence whose launch plan
(:func:`arnn_plan`) splits each 64-row tile's units across the CTAs of a
cluster, its weights packed in 4-gate blocks (:func:`pack_lstm_blocks`,
:func:`pack_arnn_weights`) once per set of weight tensors
(:func:`arnn_operands`). The f32 route is the same staging with every
product split into six bf16 passes over exact pieces
(``kernel_common.split_product`` emulates them): the context projection
as the split GEMM, then ``arnn_f32_kernel``, whose CTAs exchange the h
pieces through an L2 scratch (:func:`arnn_f32_plan`,
:func:`pack_arnn_f32_weights`, :func:`arnn_f32_operands`). Both heads run
over any vocabulary in chunks of 64 columns with a running argmax, and
the bf16 route's head hidden over any width in rounds of its hidden tile
(:func:`arnn_hid_cols`): every geometry the gate
(:func:`arnn_kernel_supports`) takes runs a Hopper route. The port's
first kernel (``csrc/arnn_decode.cu``, :func:`_decode_tiled`) runs on no
route: it is the yardstick of the Hopper routes' error at noisy weights.
``recurrent_product``, ``carry_c`` and ``ctx_projection`` are the plain
versions' steps where a check plants a fault.

Every H up to 512 runs, and in bf16 up to 640 (:func:`arnn_width`), at
any context width C (:func:`arnn_ctx_width`; :func:`arnn_kernel_supports`):
a width that is not whole 64-unit blocks runs at the next one that is, on
zero units (:func:`arnn_padded_operands`); the logits and tokens need no
slicing. C enters only the context projection GEMM, whose depth is any
whole number of 64-column slabs. Above 512 units the bf16 route's CTAs
stream half k-slabs (:func:`arnn_box_halves`) on clusters of 9 (H 576) and
10 (H 640) CTAs, sizes past the portable 8.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from inpaintnet_tpu_torch.ops import kernel_common
from inpaintnet_tpu_torch.ops.kernel_common import (
    CELL_KEYS,
    DTYPE_CODES,
    HOPPER_CONSUMERS,
    HOPPER_MAX_STAGES,
    HOPPER_ROWS,
    HOPPER_SMEM_BUDGET,
    LaunchPlan,
    WeightCache,
    check_cuda_tensor,
    check_launch,
    counts_launches,
    fitting_clusters,
    kernel_width,
    least_cost_cluster,
    load_kernels,
    lstm_gates_f32,
    pad_cell,
    pack_mma_b,
    pad_units,
    padded_cache,
    padded_width,
    round_up,
    split_bf16_pieces,
    split_blocks,
    stream_ptr,
)


def _head_pads(linear: int, vocab: int):
    """(LP, VP) of the first kernel: the head's hidden width padded to whole
    16-deep products, the vocab to whole 8-column tiles (zero weights, so
    the padding adds nothing to the real columns)."""
    return round_up(linear, 16), round_up(vocab, 8)


# --------------------------------------------------------------------------- #
# The bf16 route's Hopper recurrence (csrc/arnn_hopper.cuh)
# --------------------------------------------------------------------------- #
ARNN_SLAB_BYTES = 128 * 128  # one k-slab of a 4-gate chunk (32 units x i, f, g, o): 16 KB
ARNN_HID_COLS = 128  # hidden columns of a head chunk
ARNN_OUT_COLS = 64  # vocabulary columns of an output chunk
ARNN_MAX_UNITS = 256  # units a CTA computes: 2 consumer warpgroups x 4 chunks of 32
ARNN_MAX_WIDTH = 640  # the bf16 route's widest layer: the JAX kernel's gate takes up to 638
# k-slabs of 64 that the bf16 route's context projection GEMM sums on the
# tensor cores into one partial before a rounded f32 add: their own sum
# over a deep context (C 3,954 in one accumulator) flipped 0.28 of the
# early logits' bf16 roundings against the plain version (PERF.md); 4
# slabs, 256 values of K, is the flagship's whole sum
ARNN_CTX_GROUP = 4


@functools.lru_cache(maxsize=None)
def arnn_width(hidden: int, dtype=torch.bfloat16):
    """The width K7 runs a generation LSTM of ``hidden`` units at in
    ``dtype``: whole 64-unit blocks (``kernel_common.padded_width``) up to
    512 in f32 (``kernel_width``; the f32 route's widest), up to 640 in bf16
    (and in the plain versions' float64), where every width has a plan
    (:func:`arnn_cluster_sizes`: 576 on 9 CTAs, 640 on 10); None above."""
    if dtype == torch.float32:
        return kernel_width(hidden)
    return padded_width(hidden, lambda w: True, ARNN_MAX_WIDTH)


def arnn_ctx_width(ctx: int):
    """The depth K7's context projection GEMM runs a context of ``ctx``
    columns at: whole 64-column k-slabs, at any width (C enters no tile of
    the recurrence); None for none."""
    return round_up(ctx, 64) if ctx > 0 else None


def arnn_head_width(linear: int) -> int:
    """LP: the head's hidden width padded to whole 128-column chunks."""
    return round_up(linear, ARNN_HID_COLS)


def arnn_out_chunks(vocab: int) -> int:
    """Output chunks of both routes' heads: the vocabulary zero-padded to
    whole chunks of ``ARNN_OUT_COLS``, one at the flagship's V 60. Each CTA
    walks them all with a running argmax."""
    return -(-vocab // ARNN_OUT_COLS)


def arnn_smem_bytes(hidden: int, cluster: int, ht: int, stages: int, halves=None) -> int:
    """Dynamic shared memory of a bf16 K7 CTA (``arnn_hopper.cuh
    arnn_smem_bytes``): both h tiles and the head's hidden tile of ``ht``
    columns (64 rows of bf16, 8 KB a 64-column block), the two rings of
    ``stages`` boxes of ``halves`` 8 KB halves of a 16 KB k-slab (default
    :func:`arnn_box_halves`), and the bf16 c carries of its ``hidden /
    cluster`` units, both layers. H 640 on 10 CTAs with 2 stages of half
    boxes: 160 KB of h tiles + 16 KB hidden + 32 KB rings + 16 KB c + 1 KB
    = 230,400 bytes, the budget exactly; whole-slab boxes would need
    263,168."""
    halves = arnn_box_halves(hidden) if halves is None else halves
    return ((2 * (hidden // 64) + ht // 64) * HOPPER_ROWS * 128
            + HOPPER_CONSUMERS * stages * halves * ARNN_SLAB_BYTES // 2
            + 2 * HOPPER_ROWS * (hidden // cluster) * 2 + 1024)


def arnn_ring_stages(hidden: int, cluster: int, ht: int, halves=None) -> int:
    """Ring stages a consumer warpgroup gets beside the tiles (a hidden tile
    of ``ht`` columns; boxes of ``halves`` half k-slabs, default
    :func:`arnn_box_halves`): 2 at the flagship's H 256 with one CTA a tile,
    3 with two or four; 3 at H 576 on 9 CTAs, 2 at 640 on 10."""
    halves = arnn_box_halves(hidden) if halves is None else halves
    free = HOPPER_SMEM_BUDGET - arnn_smem_bytes(hidden, cluster, ht, 0, halves)
    return min(HOPPER_MAX_STAGES, free // (HOPPER_CONSUMERS * halves * ARNN_SLAB_BYTES // 2))


def arnn_hid_cols(hidden: int, cluster: int, lp: int, halves=None) -> int:
    """HT: the columns of the bf16 route's hidden tile, the widest whole
    number of 128-column chunks that divides the padded head width ``lp``
    and leaves a ring of two stages (0 if none does). It is ``lp`` wherever
    that fits (the flagship's 256); else the head's hidden runs in ``lp /
    HT`` rounds (H 512 at a 256-wide head: 128, two rounds; above 512 always
    128)."""
    chunks = lp // ARNN_HID_COLS
    for n in range(chunks, 0, -1):
        if chunks % n == 0 and arnn_ring_stages(hidden, cluster, n * ARNN_HID_COLS, halves) >= 2:
            return n * ARNN_HID_COLS
    return 0


def _fitting_arnn_clusters(hidden: int, lp: int, halves: int) -> list:
    """Cluster sizes of CTAs owning whole 64-unit blocks of at most 256
    units, with a hidden tile and a ring of at least two stages of
    ``halves`` boxes beside the h tiles."""
    return fitting_clusters(lambda c: (hidden // 64) % c == 0 and hidden // c <= ARNN_MAX_UNITS
                            and arnn_hid_cols(hidden, c, lp, halves) > 0, wide=True)


@functools.lru_cache(maxsize=None)
def arnn_box_halves(hidden: int) -> int:
    """Halves of a 16 KB k-slab that a bf16 K7 TMA box and ring stage hold
    (``arnn_hopper.cuh``, the kernel's ``kHalf``): 2, whole k-slabs, wherever
    some cluster fits them (every width up to 512), else 1, boxes of 32
    values of K with the 64-byte swizzle (H 576 and 640, where two h tiles
    of 64 x H leave no room for whole-slab rings at any cluster size); 0
    where neither fits. A plan that fits at the narrowest hidden tile fits
    at every head width (the hidden runs in rounds), so the head does not
    enter."""
    if hidden % 64 or hidden <= 0:
        return 0
    return next((h for h in (2, 1) if _fitting_arnn_clusters(hidden, ARNN_HID_COLS, h)), 0)


def arnn_out_kslabs(hidden: int, lp: int) -> int:
    """k-slabs of a block of the bf16 route's W_out^T (:func:`pack_arnn_weights`):
    4, a warpgroup's 32 columns of a chunk (the one-chunk layout of the
    flagship), where every plan's hidden tile is the whole head or whole
    256-column blocks of it; else 2, a chunk's 64 columns, which both
    warpgroups stream (a hidden tile of 128 columns in rounds: H 512 at a
    256-wide head)."""
    return 4 if all(ht == lp or ht % 256 == 0
                    for ht in (arnn_hid_cols(hidden, c, lp)
                               for c in arnn_cluster_sizes(hidden, lp))) else 2


def arnn_cluster_sizes(hidden: int, lp: int) -> list:
    """Cluster sizes the bf16 route takes: CTAs owning whole 64-unit blocks
    of at most 256 units, with a hidden tile and a ring of at least two
    stages of :func:`arnn_box_halves` boxes beside the h tiles
    (:func:`arnn_hid_cols`); 5 at H 320 and 7 at H 448, where no power of
    two fits, and the non-portable 9 at H 576 and 10 at H 640, where no
    portable size does (``kernel_common.fitting_clusters``): 64 units a CTA,
    one 32-unit chunk a consumer warpgroup."""
    halves = arnn_box_halves(hidden)
    if not halves or lp % ARNN_HID_COLS or lp <= 0:
        return []
    return _fitting_arnn_clusters(hidden, lp, halves)


def arnn_plan(rows: int, hidden: int, linear: int, sms: int, slots=None) -> LaunchPlan:
    """How the bf16 route runs ``rows`` rows: the cluster size of
    ``kernel_common.least_cost_cluster``, with the ring depth beside its
    hidden tile (:func:`arnn_hid_cols`). At the flagship's H 256 every batch
    up to 30 tiles (1,920 rows) on an H100 takes C 4: one wave. Raises
    ValueError for a geometry no size takes."""
    lp = arnn_head_width(linear)
    sizes = arnn_cluster_sizes(hidden, lp)
    if not sizes:
        raise ValueError(f"no K7 plan for hidden size {hidden}, head {linear}")
    cluster = least_cost_cluster(rows, sizes, sms, slots)
    return LaunchPlan(cluster, arnn_ring_stages(hidden, cluster, arnn_hid_cols(hidden, cluster,
                                                                               lp)))


@functools.lru_cache(maxsize=None)
def arnn_slots(hidden: int, lp: int, device_index: int) -> dict:
    """{C: clusters of C CTAs of the bf16 route the card runs at once},
    asked once per geometry and card."""
    def slots(c):
        ht = arnn_hid_cols(hidden, c, lp)
        return load_kernels().inpaint_arnn_slots(hidden, c, ht, arnn_ring_stages(hidden, c, ht),
                                                 arnn_box_halves(hidden))

    with torch.cuda.device(device_index):
        counts = {c: slots(c) for c in arnn_cluster_sizes(hidden, lp)}
    bad = sorted(c for c, n in counts.items() if n < 1)
    if bad:
        raise RuntimeError(f"arnn_sampled_decode: the card runs no cluster of sizes {bad} at "
                           f"hidden size {hidden}")
    return counts


def arnn_card_plan(rows: int, hidden: int, linear: int, device) -> LaunchPlan:
    """:func:`arnn_plan` on the card ``device`` names, with its own SM count
    and cluster slots: the plan :func:`arnn_sampled_decode` launches."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return arnn_plan(rows, hidden, linear,
                     torch.cuda.get_device_properties(index).multi_processor_count,
                     arnn_slots(hidden, arnn_head_width(linear), index))


def arnn_hopper_supports(hidden: int, linear: int, vocab: int) -> bool:
    """Whether K7's bf16 Hopper route takes this geometry: a cluster plan
    (:func:`arnn_cluster_sizes`), at any vocabulary."""
    return vocab >= 1 and bool(arnn_cluster_sizes(hidden, arnn_head_width(linear)))


# --------------------------------------------------------------------------- #
# The f32 route's Hopper recurrence (csrc/arnn_hopper.cuh arnn_f32_kernel)
# --------------------------------------------------------------------------- #
ARNN_F32_UNITS = 16  # units of a chunk: its i, f, g, o rows are one 64-row wgmma tile
ARNN_F32_BLOCK_BYTES = 64 * 128  # a 64 x 64 bf16 block of packed weights
ARNN_F32_STAGE_BYTES = 3 * HOPPER_ROWS * 128 + 6 * ARNN_F32_BLOCK_BYTES  # 72 KB
ARNN_F32_STAGES = 2
ARNN_F32_CARRY_PAD = 8  # f32 padding of the c carries' rows
ARNN_F32_MAX_ROUNDS = 4  # 32-unit rounds a CTA: two chunks of 16 a round, one a warpgroup


def arnn_f32_smem_bytes(hidden: int, cluster: int) -> int:
    """Dynamic shared memory of an f32 K7 CTA (``arnn_hopper.cuh
    arnn_f32_smem_bytes``): the two 72 KB ring stages (a k-slab of the
    operand's three pieces and of two chunks' three weight pieces) and the
    f32 c carries of its ``hidden / cluster`` units, both layers."""
    return (ARNN_F32_STAGES * ARNN_F32_STAGE_BYTES
            + 2 * HOPPER_ROWS * (hidden // cluster + ARNN_F32_CARRY_PAD) * 4 + 1024)


def arnn_f32_cluster_sizes(hidden: int, lp: int) -> list:
    """Cluster sizes the f32 route takes: CTAs owning whole pairs of 16-unit
    chunks (32 units a round, one chunk a consumer warpgroup), at most four
    rounds (128 units), and a block that fits shared memory, at any head
    width: H 64 takes 1 and 2, the flagship's H 256 takes 2, 4 and 8, H 512
    takes 4 and 8; H 320 takes 5, where no power of two fits
    (``kernel_common.fitting_clusters``)."""
    if hidden % 64 or hidden <= 0 or lp % ARNN_HID_COLS or lp <= 0:
        return []
    return fitting_clusters(lambda c: hidden % c == 0 and (hidden // c) % 32 == 0
                            and hidden // c // 32 <= ARNN_F32_MAX_ROUNDS
                            and arnn_f32_smem_bytes(hidden, c) <= HOPPER_SMEM_BUDGET)


def arnn_f32_plan(rows: int, hidden: int, linear: int, sms: int, slots=None) -> LaunchPlan:
    """How the f32 route runs ``rows`` rows: the cluster size of
    ``kernel_common.least_cost_cluster`` (a CTA's chain of rounds shrinks as 1/C),
    with the ring's two stages. At the flagship's H 256 on an H100 every
    batch up to 15 tiles (960 rows) takes C 8: one wave. Raises ValueError
    for a geometry no size takes."""
    sizes = arnn_f32_cluster_sizes(hidden, arnn_head_width(linear))
    if not sizes:
        raise ValueError(f"no f32 K7 plan for hidden size {hidden}, head {linear}")
    return LaunchPlan(least_cost_cluster(rows, sizes, sms, slots), ARNN_F32_STAGES)


@functools.lru_cache(maxsize=None)
def arnn_f32_slots(hidden: int, lp: int, device_index: int) -> dict:
    """{C: clusters of C CTAs of the f32 route the card runs at once},
    asked once per geometry and card."""
    with torch.cuda.device(device_index):
        counts = {c: load_kernels().inpaint_arnn_f32_slots(hidden, c, lp)
                  for c in arnn_f32_cluster_sizes(hidden, lp)}
    bad = sorted(c for c, n in counts.items() if n < 1)
    if bad:
        raise RuntimeError(f"arnn_sampled_decode: the card runs no f32 cluster of sizes {bad} "
                           f"at hidden size {hidden}")
    return counts


def arnn_f32_card_plan(rows: int, hidden: int, linear: int, device) -> LaunchPlan:
    """:func:`arnn_f32_plan` on the card ``device`` names: the plan
    :func:`arnn_sampled_decode` launches in f32."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return arnn_f32_plan(rows, hidden, linear,
                         torch.cuda.get_device_properties(index).multi_processor_count,
                         arnn_f32_slots(hidden, arnn_head_width(linear), index))


def arnn_f32_supports(hidden: int, linear: int, vocab: int) -> bool:
    """Whether K7's f32 Hopper route takes this geometry: a cluster plan
    (:func:`arnn_f32_cluster_sizes`), at any vocabulary."""
    return vocab >= 1 and bool(arnn_f32_cluster_sizes(hidden, arnn_head_width(linear)))


def _route_supports(hidden: int, linear: int, vocab: int, dtype) -> bool:
    """Whether a Hopper route takes this geometry in ``dtype``."""
    if dtype == torch.bfloat16:
        return arnn_hopper_supports(hidden, linear, vocab)
    return dtype == torch.float32 and arnn_f32_supports(hidden, linear, vocab)


def arnn_kernel_supports(hidden: int, ctx: int, linear: int, vocab: int, dtype) -> bool:
    """Whether K7 takes this geometry: H up to 512 (in bf16 up to 640) at
    its :func:`arnn_width` and any C at its :func:`arnn_ctx_width`, on zero
    units (:func:`arnn_padded_operands`), and a plan of the dtype's Hopper
    route at that H (:func:`arnn_hopper_supports`,
    :func:`arnn_f32_supports`), which every such width has at any head width
    and vocabulary: every geometry the JAX kernel's gate takes
    (``inpaintnet_tpu/models/anticipation_rnn.py _use_pallas_decode``)."""
    if dtype not in DTYPE_CODES or arnn_ctx_width(ctx) is None:
        return False
    width = arnn_width(hidden, dtype)
    return width is not None and _route_supports(width, linear, vocab, dtype)


def _build_padded_arnn(*weights, hp: int, cp: int) -> dict:
    """The generation LSTM and head hidden of ``weights`` (layer 0's and
    layer 1's ``CELL_KEYS``, the token embedding table, linear_1's w) at
    ``hp`` units, layer 0's context rows at ``cp``."""
    p0, p1 = (dict(zip(CELL_KEYS, weights[4 * i:4 * i + 4])) for i in range(2))
    hidden, emb_dim = p0["w_hh"].shape[0], weights[8].shape[1]
    ctx = p0["w_ih"].shape[0] - emb_dim

    def ctx_rows(w):  # layer 0 reads [token embedding E | constraint output C]
        return torch.cat([w[:emb_dim], pad_units(w[emb_dim:], ctx, cp, dim=0)])

    def unit_rows(w):
        return pad_units(w, hidden, hp, dim=0)
    return {"lstm_generation": [pad_cell(p0, hidden, hp, 4, ctx_rows),
                                pad_cell(p1, hidden, hp, 4, unit_rows)],
            "linear_1_w": unit_rows(weights[9])}


# K7's generation LSTM and head hidden at the widths it runs them at, built
# once per set of weight tensors
padded_arnn = padded_cache(_build_padded_arnn)


def arnn_padded_operands(params, ctx: torch.Tensor) -> tuple:
    """K7's operands at :func:`arnn_width` of H and :func:`arnn_ctx_width`
    of C: the generation LSTM with zero units (``kernel_common.pad_cell``
    with 4 gates; layer 0's W_ih rows of the context and layer 1's, and
    linear_1's input rows) and the context with zero columns. H and C pad
    independently (H 48 with C 100 runs at 64 and 128); the head's hidden L
    is padded by the packings already. The token table, start embedding and
    head are unchanged, so the logits and tokens are the narrow model's.

    C's one sum of real values is the context projection: the GEMM walks
    its k-slabs in order, and the zero columns meet W_ctx's zero rows after
    every real one, adding exact zeros, so the sum is the one the real C
    columns give (no other blocking, as cuBLAS may take at a padded depth:
    ``decode_kernel.narrow_ctx_xw``). The context's pad is a copy per call:
    at C 3,954 (run at 3,968) and 512 x 384 rows, 1.55 GB read and 1.56 GB
    written. -> (params, ctx)"""
    p0, p1 = params["lstm_generation"]
    hidden, width = p0["w_hh"].shape[0], ctx.shape[2]
    narrow = padded_arnn(*(p[k] for p in (p0, p1) for k in CELL_KEYS),
                         params["note_embedding"]["table"], params["linear_1"]["w"],
                         hp=arnn_width(hidden, p0["w_hh"].dtype), cp=arnn_ctx_width(width))
    return ({"note_embedding": params["note_embedding"],
             "lstm_generation": narrow["lstm_generation"],
             "linear_1": {"w": narrow["linear_1_w"], "b": params["linear_1"]["b"]},
             "linear_output_notes": params["linear_output_notes"]},
            pad_units(ctx, width, arnn_ctx_width(width)))


def pack_lstm_blocks(w: torch.Tensor) -> torch.Tensor:
    """A (K, 4H) LSTM weight as the bf16 route streams it: W^T in 4-gate
    chunks of 32 units, (H / 32 chunks, K / 64 k-slabs, 128, 64); row
    32 g + u of chunk c's k-slab k is gate g's column of unit 32 c + u at
    inputs [64 k, 64 k + 64)."""
    k_dim, hidden = w.shape[0], w.shape[1] // 4
    wt = w.t().reshape(4, hidden // 32, 32, k_dim).permute(1, 0, 2, 3)
    return wt.reshape(hidden // 32, 128, k_dim // 64, 64).permute(0, 2, 1, 3).contiguous()


def pack_arnn_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out) -> torch.Tensor:
    """The bf16 route's weights as one array of (128, 64) k-slabs (16 KB
    blocks), in the order the recurrence streams them: W_hh0 by chunk
    (:func:`pack_lstm_blocks`); layer 1 by chunk, each chunk's W_ih1
    k-slabs then its W_hh1 k-slabs (one stream, two accumulators); W_l1^T in
    chunks of 128 hidden columns (zero past the head's width); W_out^T by
    chunks of 64 vocabulary columns (zero past V, :func:`arnn_out_chunks`)
    in blocks of :func:`arnn_out_kslabs` k-slabs. With 4: each chunk's
    columns 0-31, then 32-63, one a consumer warpgroup's, each half in
    blocks of four 32-row k-slabs over the head padded to 256: row 32 kk + r
    of half w's block b of chunk c is column 64 c + 32 w + r at inputs
    64 (4 b + kk) + [0, 64). With 2: each chunk in LP / 128 blocks of two
    64-row k-slabs, row 64 kk + r of block b column 64 c + r at inputs
    64 (2 b + kk) + [0, 64), which both warpgroups stream, warpgroup w
    reading its rows 64 kk + 32 w + [0, 32)."""
    hidden, linear = w_l1.shape
    vocab = w_out.shape[1]
    lp = arnn_head_width(linear)
    layer1 = torch.cat([pack_lstm_blocks(w_ih1), pack_lstm_blocks(w_hh1)], dim=1)
    l1 = torch.nn.functional.pad(w_l1, (0, lp - linear)).t()  # (LP, H)
    l1 = l1.reshape(lp // 128, 128, hidden // 64, 64).permute(0, 2, 1, 3)
    chunks, kslabs = arnn_out_chunks(vocab), arnn_out_kslabs(hidden, lp)
    width = round_up(lp, 64 * kslabs)
    out = torch.zeros((chunks * ARNN_OUT_COLS, width), dtype=w_out.dtype, device=w_out.device)
    out[:vocab, :linear] = w_out.t()
    rows = 128 // kslabs  # of a k-slab in a block: 32 (a warpgroup's half) or 64
    out = out.reshape(chunks, ARNN_OUT_COLS // rows, rows, width // (64 * kslabs), kslabs, 64)
    out = out.permute(0, 1, 3, 4, 2, 5)
    return torch.cat([b.reshape(-1, 128, 64)
                      for b in (pack_lstm_blocks(w_hh0), layer1, l1, out)]).contiguous()


def pack_arnn_f32_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out) -> torch.Tensor:
    """The f32 route's weights as one array of (64, 64) bf16 blocks (8 KB),
    each weight's three pieces (``kernel_common.split_bf16_pieces``), in the
    order the recurrence streams them (``kernel_common.split_blocks``): W_hh0, W_ih1 and
    W_hh1 by pairs of 16-unit chunks, row 16 g + u of chunk c W's column g H
    + 16 c + u; W_l1^T by rounds of 128 hidden columns (zero past the head's
    width); W_out^T by pairs of 64-column chunks (zero past V, a zero chunk
    after an odd last one)."""
    hidden, linear = w_l1.shape
    vocab = w_out.shape[1]
    lp = arnn_head_width(linear)

    def lstm(w):
        wt = w.t().reshape(4, hidden // ARNN_F32_UNITS, ARNN_F32_UNITS, w.shape[0])
        return split_blocks(torch.stack(split_bf16_pieces(
            wt.permute(1, 0, 2, 3).reshape(4 * hidden, w.shape[0]))), 64)

    l1 = torch.nn.functional.pad(w_l1.float(), (0, lp - linear)).t()
    pairs = -(-arnn_out_chunks(vocab) // 2)
    out = torch.zeros((pairs * 2 * ARNN_OUT_COLS, lp), dtype=torch.float32, device=w_out.device)
    out[:vocab, :linear] = w_out.float().t()
    return torch.cat([lstm(w_hh0), lstm(w_ih1), lstm(w_hh1),
                      split_blocks(torch.stack(split_bf16_pieces(l1)), 64),
                      split_blocks(torch.stack(split_bf16_pieces(out)), 64)]).contiguous()


def arnn_map(packed: torch.Tensor, halves: int = 2):
    """The tensor map (a 128-byte CUtensorMap, in a host buffer) of the
    packed (blocks, 128, 64) bf16 weights, one block a box (``halves`` 2,
    the 128-byte swizzle) or half of one, 32 values of K (1, the 64-byte
    swizzle). -> (buffer, its aligned address); keep ``packed`` alive as
    long as the map."""
    buf = ctypes.create_string_buffer(128 + 64)
    addr = (ctypes.addressof(buf) + 63) // 64 * 64
    check_launch(load_kernels().inpaint_arnn_map(packed.data_ptr(), packed.shape[0], halves,
                                                 addr), "arnn_map")
    return buf, addr


def _build_arnn_operands(table, w_ih0, b_ih0, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1,
                         w_l1, b_l1, w_out, b_out) -> dict:
    E, linear = table.shape[1], w_l1.shape[1]
    lp = arnn_head_width(linear)
    w_tok = w_ih0[:E].float()
    packed = pack_arnn_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out)
    buf, addr = arnn_map(packed, arnn_box_halves(w_hh0.shape[0]))
    pad = torch.nn.functional.pad
    return {"w_tok": w_tok, "tok_tab": (table.float() @ w_tok).to(table.dtype),
            "w_ctx_t": w_ih0[E:].t().contiguous(),
            "bias": torch.stack([b_ih0, b_hh0, b_ih1, b_hh1]),
            "b_l1": pad(b_l1, (0, lp - linear)),
            "b_out": pad(b_out, (0, arnn_out_chunks(b_out.shape[0]) * ARNN_OUT_COLS
                                 - b_out.shape[0])),
            "packed": packed, "map": buf, "map_addr": addr}


# The bf16 route's per-weight operands, built once per set of weight
# tensors: the token table, W_ctx^T, the bias stack, the padded head
# biases, the packed weights and their tensor map
arnn_operands = WeightCache(_build_arnn_operands)


def _build_arnn_f32_operands(table, w_ih0, b_ih0, w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1,
                             w_l1, b_l1, w_out, b_out) -> dict:
    E, linear = table.shape[1], w_l1.shape[1]
    lp = arnn_head_width(linear)
    w_tok = w_ih0[:E].float()
    packed = pack_arnn_f32_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out)
    buf = ctypes.create_string_buffer(128 + 64)
    addr = (ctypes.addressof(buf) + 63) // 64 * 64
    check_launch(load_kernels().inpaint_arnn_f32_map(packed.data_ptr(), packed.shape[0], addr),
                 "arnn_f32_map")
    pad = torch.nn.functional.pad
    return {"w_tok": w_tok, "tok_tab": table.float() @ w_tok,
            "w_ctx": torch.stack(split_bf16_pieces(w_ih0[E:].t())).contiguous(),
            "bias": torch.stack([b_ih0, b_hh0, b_ih1, b_hh1]).float(),
            "b_l1": pad(b_l1.float(), (0, lp - linear)),
            "b_out": pad(b_out.float(), (0, -(-arnn_out_chunks(b_out.shape[0]) // 2)
                                         * 2 * ARNN_OUT_COLS - b_out.shape[0])),
            "packed": packed, "map": buf, "map_addr": addr}


# The f32 route's per-weight operands, built once per set of weight tensors:
# the token table, W_ctx^T's pieces (the split GEMM's), the bias stack, the
# padded head biases, the packed weight pieces and their tensor map
arnn_f32_operands = WeightCache(_build_arnn_f32_operands)


def arnn_chunk_rows(batch: int, seq_len: int, hidden: int) -> int:
    """Rows of one chunk of the bf16 route: whole 64-row tiles whose f32
    context projection (rows, T, 4H) fits ``encoder_kernel.XW_SCRATCH_BYTES``
    (every row of the flagship's batch 512 x 384 ticks: 805 MB), at most
    ``batch``."""
    from inpaintnet_tpu_torch.ops import encoder_kernel

    per_row = seq_len * 4 * hidden * 4
    rows = encoder_kernel.XW_SCRATCH_BYTES // per_row // HOPPER_ROWS * HOPPER_ROWS
    return min(max(HOPPER_ROWS, rows), batch)


def arnn_cuda_launches(dtype, batch: int, seq_len: int, hidden: int, linear: int,
                       vocab: int) -> int:
    """CUDA kernel launches of one K7 call: two a chunk of rows (the context
    projection GEMM, then the recurrence) on either Hopper route, at every
    geometry the gate takes (a narrow H runs at its :func:`arnn_width`).
    Raises ValueError for one it does not."""
    hidden = arnn_width(hidden, dtype) or hidden
    if not _route_supports(hidden, linear, vocab, dtype):
        raise ValueError(f"arnn_cuda_launches: no K7 route for dtype {dtype}, hidden size "
                         f"{hidden}, head {linear} x {vocab}")
    return 2 * -(-batch // arnn_chunk_rows(batch, seq_len, hidden))


def arnn_decode_inputs(params, start_emb: torch.Tensor) -> dict:
    """The loop's operands, all in the parameter dtype: ``tok_tab``
    (n_tok, 4H) = emb @ W_ih0[:E]; ``start_xw`` (4H,) = start_emb @
    W_ih0[:E]; ``w_ctx`` (C, 4H) = W_ih0[E:]; ``bias`` (4, 4H) = b_ih0,
    b_hh0, b_ih1, b_hh1."""
    p0, p1 = params["lstm_generation"]
    emb = params["note_embedding"]["table"]
    dtype, E = emb.dtype, emb.shape[1]
    w_tok = p0["w_ih"][:E].float()
    return {
        "tok_tab": (emb.float() @ w_tok).to(dtype),
        "start_xw": (start_emb.float().reshape(1, E) @ w_tok).to(dtype).reshape(-1),
        "w_ctx": p0["w_ih"][E:].contiguous(),
        "bias": torch.stack([p0["b_ih"], p0["b_hh"], p1["b_ih"], p1["b_hh"]]),
    }


def recurrent_product(h: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The plain versions' products on the carried h of each layer: h in f32
    @ f32 ``W_hh`` (one place, so a check can plant h taken as one bf16
    piece)."""
    return h.float() @ w_hh


def carry_c(c: torch.Tensor, dtype) -> torch.Tensor:
    """The c carry as the next tick reads it: rounded to the parameter
    dtype (one place, so a check can plant a carry kept in f32)."""
    return c.to(dtype)


def ctx_projection(ctx: torch.Tensor, w_ctx: torch.Tensor) -> torch.Tensor:
    """The bf16 route's context projection of every tick, hoisted out of the
    recurrence: (B, T, C) @ (C, 4H), summed and kept in f32 (one place, so
    a check can plant a projection rounded to bf16)."""
    return ctx.float() @ w_ctx.float()


def _decode_loop(params, ctx, score, force_mask, start_emb, projection):
    """The plain versions' tick loop; ``projection`` (B, T, 4H) f32 is
    ``ctx @ W_ctx`` taken up front, or None to take it inside the loop."""
    p0, p1 = params["lstm_generation"]
    dtype = p0["w_hh"].dtype
    hidden = p0["w_hh"].shape[0]
    batch, seq_len, _ = ctx.shape
    ins = arnn_decode_inputs(params, start_emb)
    f = {k: v.float() for k, v in (("w_ctx", ins["w_ctx"]), ("whh0", p0["w_hh"]),
                                   ("wih1", p1["w_ih"]), ("whh1", p1["w_hh"]),
                                   ("bias", ins["bias"]),
                                   ("w_l1", params["linear_1"]["w"]),
                                   ("b_l1", params["linear_1"]["b"]),
                                   ("w_out", params["linear_output_notes"]["w"]),
                                   ("b_out", params["linear_output_notes"]["b"]))}
    zeros = ctx.new_zeros((batch, hidden))
    h0 = c0 = h1 = c1 = zeros
    prev = ins["start_xw"].float().expand(batch, -1)
    logits, tokens = [], []
    for t in range(seq_len):
        cw = ctx[:, t].float() @ f["w_ctx"] if projection is None else projection[:, t]
        xw0 = prev + cw + f["bias"][0]
        hw0 = recurrent_product(h0, f["whh0"]) + f["bias"][1]
        h0, c0_new = lstm_gates_f32(xw0, hw0, c0.float(), hidden)
        h0, c0 = h0.to(dtype), carry_c(c0_new, dtype)
        xw1 = h0.float() @ f["wih1"] + f["bias"][2]
        hw1 = recurrent_product(h1, f["whh1"]) + f["bias"][3]
        h1, c1_new = lstm_gates_f32(xw1, hw1, c1.float(), hidden)
        h1, c1 = h1.to(dtype), carry_c(c1_new, dtype)
        hid = torch.relu(h1.float() @ f["w_l1"] + f["b_l1"]).to(dtype)
        lg = hid.float() @ f["w_out"] + f["b_out"]
        sampled = torch.argmax(lg, dim=-1)  # first index among equal maxima
        tok = torch.where(force_mask[:, t] > 0, score[:, t].long(), sampled)
        prev = ins["tok_tab"][tok].float()
        logits.append(lg.to(dtype))
        tokens.append(tok)
    return torch.stack(logits, dim=1), torch.stack(tokens, dim=1).to(torch.int32)


def arnn_sampled_decode_reference(params, ctx: torch.Tensor, score: torch.Tensor,
                                  force_mask: torch.Tensor, start_emb: torch.Tensor):
    """Plain version of K7.

    :param params: ConstraintModelGaussianReg params (2 generation layers)
    :param ctx: (B, T, C) constraint-LSTM outputs in the parameter dtype
    :param score: (B, T) int ground-truth tokens; force_mask: (B, T) int, 1
        where the token at that tick is forced
    :param start_emb: (1, E) embedding of the tick -1 input
    :return: (logits (B, T, V) in the parameter dtype, tokens (B, T) int32)
    """
    return _decode_loop(params, ctx, score, force_mask, start_emb, None)


def arnn_sampled_decode_staged_reference(params, ctx: torch.Tensor, score: torch.Tensor,
                                         force_mask: torch.Tensor, start_emb: torch.Tensor):
    """The plain version staged as K7's bf16 route runs: the context product
    of every tick first (:func:`ctx_projection`, f32), each tick adding its
    row in the plain version's order, ``(prev_xw + row) + b_ih0``. The same
    function as :func:`arnn_sampled_decode_reference`; the products' sums
    may differ in the last bit (another order). Arguments and results as
    that function's."""
    w_ctx = params["lstm_generation"][0]["w_ih"][start_emb.shape[1]:]
    return _decode_loop(params, ctx, score, force_mask, start_emb, ctx_projection(ctx, w_ctx))


def _check_arnn_args(params, ctx, score, force_mask, start_emb):
    """The K7 wrapper's checks of what the kernels take. -> (batch, seq_len,
    C, hidden, linear, vocab, dtype, device); raises ValueError otherwise."""
    if ctx.device.type != "cuda":
        raise ValueError(f"arnn_sampled_decode: no kernel for device {ctx.device}")
    if len(params["lstm_generation"]) != 2:
        raise ValueError("arnn_sampled_decode: takes a 2-layer generation LSTM")
    p0, p1 = params["lstm_generation"]
    device, dtype = ctx.device, p0["w_hh"].dtype
    batch, seq_len, C = ctx.shape
    hidden = p0["w_hh"].shape[0]
    linear, vocab = params["linear_output_notes"]["w"].shape
    if not (arnn_width(hidden, dtype) == hidden and arnn_ctx_width(C) == C
            and arnn_kernel_supports(hidden, C, linear, vocab, dtype)):
        raise ValueError(f"arnn_sampled_decode: no kernel for dtype {dtype}, hidden size "
                         f"{hidden}, context {C}, head {linear} x {vocab}")
    emb = params["note_embedding"]["table"]
    E = emb.shape[1]
    check_cuda_tensor("ctx", ctx, (batch, seq_len, C), dtype, device)
    for tag, t in (("score", score), ("force_mask", force_mask)):
        check_cuda_tensor(tag, t, (batch, seq_len), torch.int32, device)
    check_cuda_tensor("start_emb", start_emb, (1, E), dtype, device)
    check_cuda_tensor("note_embedding.table", emb, (emb.shape[0], E), dtype, device)
    check_cuda_tensor("lstm_generation0.w_ih", p0["w_ih"], (E + C, 4 * hidden), dtype, device)
    for tag, w in (("lstm_generation0.w_hh", p0["w_hh"]), ("lstm_generation1.w_ih", p1["w_ih"]),
                   ("lstm_generation1.w_hh", p1["w_hh"])):
        check_cuda_tensor(tag, w, (hidden, 4 * hidden), dtype, device)
    for tag, b in (("lstm_generation0.b_ih", p0["b_ih"]), ("lstm_generation0.b_hh", p0["b_hh"]),
                   ("lstm_generation1.b_ih", p1["b_ih"]), ("lstm_generation1.b_hh", p1["b_hh"])):
        check_cuda_tensor(tag, b, (4 * hidden,), dtype, device)
    check_cuda_tensor("linear_1.w", params["linear_1"]["w"], (hidden, linear), dtype, device)
    check_cuda_tensor("linear_1.b", params["linear_1"]["b"], (linear,), dtype, device)
    check_cuda_tensor("linear_output_notes.w", params["linear_output_notes"]["w"],
                      (linear, vocab), dtype, device)
    check_cuda_tensor("linear_output_notes.b", params["linear_output_notes"]["b"], (vocab,),
                      dtype, device)
    return batch, seq_len, C, hidden, linear, vocab, dtype, device


def _decode_hopper(params, ctx, score, force_mask, start_emb, shape):
    """The bf16 Hopper route: per chunk of rows, the context projection
    GEMM, then the cluster recurrence (csrc/arnn_hopper.cuh). ``shape`` is
    :func:`_check_arnn_args`'."""
    batch, seq_len, C, hidden, linear, vocab, dtype, device = shape
    p0, p1 = params["lstm_generation"]
    ops = arnn_operands(params["note_embedding"]["table"], p0["w_ih"], p0["b_ih"], p0["w_hh"],
                        p0["b_hh"], p1["w_ih"], p1["b_ih"], p1["w_hh"], p1["b_hh"],
                        params["linear_1"]["w"], params["linear_1"]["b"],
                        params["linear_output_notes"]["w"], params["linear_output_notes"]["b"])
    # the tick-0 input depends on the call's start embedding, not on the weights
    start_xw = (start_emb.float() @ ops["w_tok"]).to(dtype).reshape(-1)
    lp = arnn_head_width(linear)
    logits = torch.empty((batch, seq_len, vocab), dtype=dtype, device=device)
    tokens = torch.empty((batch, seq_len), dtype=torch.int32, device=device)
    lib = load_kernels()
    chunk = arnn_chunk_rows(batch, seq_len, hidden)
    for r0 in range(0, batch, chunk):
        rows = min(chunk, batch - r0)
        plan = arnn_card_plan(rows, hidden, linear, device)
        ht = arnn_hid_cols(hidden, plan.cluster, lp)
        xwc = torch.empty((rows, seq_len, 4 * hidden), dtype=torch.float32, device=device)
        check_launch(lib.inpaint_arnn_ctx_gemm(ctx[r0].data_ptr(), ops["w_ctx_t"].data_ptr(),
                                               xwc.data_ptr(), rows * seq_len, C, 4 * hidden,
                                               ARNN_CTX_GROUP, stream_ptr()),
                     "arnn_sampled_decode's GEMM")
        check_launch(lib.inpaint_arnn_decode_bf16(
            ops["map_addr"], xwc.data_ptr(), score[r0].data_ptr(), force_mask[r0].data_ptr(),
            ops["tok_tab"].data_ptr(), start_xw.data_ptr(), ops["bias"].data_ptr(),
            ops["b_l1"].data_ptr(), ops["b_out"].data_ptr(), logits[r0].data_ptr(),
            tokens[r0].data_ptr(), rows, seq_len, hidden, lp, ht, vocab, plan.cluster,
            plan.stages, kernel_common.head_ties(), arnn_out_kslabs(hidden, lp),
            arnn_box_halves(hidden), stream_ptr()), "arnn_sampled_decode")
    return logits, tokens


def _decode_hopper_f32(params, ctx, score, force_mask, start_emb, shape):
    """The f32 Hopper route: per chunk of rows, the context projection as the
    split GEMM (the chunk's context split into its three bf16 pieces), then
    the split cluster recurrence (csrc/arnn_hopper.cuh arnn_f32_kernel).
    ``shape`` is :func:`_check_arnn_args`'."""
    batch, seq_len, C, hidden, linear, vocab, dtype, device = shape
    p0, p1 = params["lstm_generation"]
    ops = arnn_f32_operands(params["note_embedding"]["table"], p0["w_ih"], p0["b_ih"],
                            p0["w_hh"], p0["b_hh"], p1["w_ih"], p1["b_ih"], p1["w_hh"],
                            p1["b_hh"], params["linear_1"]["w"], params["linear_1"]["b"],
                            params["linear_output_notes"]["w"],
                            params["linear_output_notes"]["b"])
    start_xw = (start_emb.float() @ ops["w_tok"]).reshape(-1)
    lp = arnn_head_width(linear)
    logits = torch.empty((batch, seq_len, vocab), dtype=dtype, device=device)
    tokens = torch.empty((batch, seq_len), dtype=torch.int32, device=device)
    lib = load_kernels()
    chunk = arnn_chunk_rows(batch, seq_len, hidden)
    for r0 in range(0, batch, chunk):
        rows = min(chunk, batch - r0)
        plan = arnn_f32_card_plan(rows, hidden, linear, device)
        pieces = torch.stack(split_bf16_pieces(ctx[r0:r0 + rows])).contiguous()
        xwc = torch.empty((rows, seq_len, 4 * hidden), dtype=torch.float32, device=device)
        check_launch(lib.inpaint_arnn_ctx_gemm_f32(pieces.data_ptr(), ops["w_ctx"].data_ptr(),
                                                   xwc.data_ptr(), rows * seq_len, C,
                                                   4 * hidden, stream_ptr()),
                     "arnn_sampled_decode's GEMM")
        del pieces
        # the h0 / h1 / hidden pieces' exchange, zero: tick -1's h0 and h1
        scratch = torch.zeros((-(-rows // HOPPER_ROWS), 3, 2, 3, HOPPER_ROWS, max(hidden, lp)),
                              dtype=torch.bfloat16, device=device)
        check_launch(lib.inpaint_arnn_decode_f32(
            ops["map_addr"], xwc.data_ptr(), score[r0].data_ptr(), force_mask[r0].data_ptr(),
            ops["tok_tab"].data_ptr(), start_xw.data_ptr(), ops["bias"].data_ptr(),
            ops["b_l1"].data_ptr(), ops["b_out"].data_ptr(), logits[r0].data_ptr(),
            tokens[r0].data_ptr(), scratch.data_ptr(), rows, seq_len, hidden, lp, vocab,
            plan.cluster, kernel_common.head_ties(), stream_ptr()), "arnn_sampled_decode")
    return logits, tokens


def _decode_tiled(params, ctx, score, force_mask, start_emb, shape):
    """The first kernel of the port (csrc/arnn_decode.cu): one block a tile
    of 16 (f32) or 32 (bf16) rows, every product inside the tick loop. No
    route of :func:`arnn_sampled_decode` runs it: checks call it as the
    yardstick of the Hopper routes' error at noisy weights, at geometries
    whose tile fits one block's shared memory (the flagship's). ``shape``
    is :func:`_check_arnn_args`'."""
    batch, seq_len, C, hidden, linear, vocab, dtype, device = shape
    p0, p1 = params["lstm_generation"]
    ins = arnn_decode_inputs(params, start_emb)
    lp, vp = _head_pads(linear, vocab)
    pad = torch.nn.functional.pad
    w_l1 = pad(params["linear_1"]["w"], (0, lp - linear))
    b_l1 = pad(params["linear_1"]["b"], (0, lp - linear))
    w_out = pad(params["linear_output_notes"]["w"], (0, vp - vocab, 0, lp - linear))
    b_out = pad(params["linear_output_notes"]["b"], (0, vp - vocab))
    w_ctx, whh0, wih1, whh1, w_l1, w_out = (
        pack_mma_b(w) for w in (ins["w_ctx"], p0["w_hh"], p1["w_ih"], p1["w_hh"], w_l1, w_out))
    logits = torch.empty((batch, seq_len, vocab), dtype=dtype, device=device)
    tokens = torch.empty((batch, seq_len), dtype=torch.int32, device=device)
    err = load_kernels().inpaint_arnn_decode(
        DTYPE_CODES[dtype], ctx.data_ptr(), score.data_ptr(), force_mask.data_ptr(),
        ins["tok_tab"].data_ptr(), ins["start_xw"].data_ptr(), w_ctx.data_ptr(),
        whh0.data_ptr(), wih1.data_ptr(), whh1.data_ptr(), ins["bias"].data_ptr(),
        w_l1.data_ptr(), b_l1.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        logits.data_ptr(), tokens.data_ptr(), batch, seq_len, hidden, C, lp, vocab, vp,
        stream_ptr())
    check_launch(err, "arnn_sampled_decode")
    return logits, tokens


@counts_launches  # proves a run went through K7
def arnn_sampled_decode(params, ctx: torch.Tensor, score: torch.Tensor,
                        force_mask: torch.Tensor, start_emb: torch.Tensor):
    """K7: the argmax decode with forced ticks over the whole sequence.

    Arguments and results as :func:`arnn_sampled_decode_reference`, with
    (in, out) weights in f32 or bf16, ``score`` and ``force_mask`` int32;
    the entries of ``score`` at forced ticks must lie in [0, n_tok). The
    dtype's Hopper route runs every geometry :func:`arnn_kernel_supports`
    takes; the wrapper raises ValueError on any other."""
    if ctx.device.type == "cpu":
        return arnn_sampled_decode_reference(params, ctx, score, force_mask, start_emb)
    w_hh, width = params["lstm_generation"][0]["w_hh"], ctx.shape[2]
    padded = arnn_width(w_hh.shape[0], w_hh.dtype), arnn_ctx_width(width)
    if None not in padded and padded != (w_hh.shape[0], width):  # zero units, 64-unit blocks
        return arnn_sampled_decode(*arnn_padded_operands(params, ctx), score, force_mask,
                                   start_emb)
    shape = _check_arnn_args(params, ctx, score, force_mask, start_emb)
    route = _decode_hopper if shape[6] == torch.bfloat16 else _decode_hopper_f32
    out = route(params, ctx, score, force_mask, start_emb, shape)
    arnn_sampled_decode.launches += 1
    return out


def decode_agreement(got, want, force_mask: torch.Tensor, early_ticks: int = 8) -> dict:
    """How far two argmax decodes of the same inputs agree (K7 against its
    plain version, or a port against the JAX package). Once a row's tokens
    differ, the two decodes feed back different tokens and the row's later
    ticks are not comparable, so:

    - ``tokens``: the share of equal tokens over all ticks (printed; a
      near-tie flip makes the rest of its row differ);
    - ``logits_max``, ``logits_mean``: |a - b| of the logits at the ticks
      up to and including each row's first mismatch;
    - ``tie_gap``: at each row's first mismatch, how far below the largest
      logit of ``want`` both tokens lie (the largest over the rows): a flip
      of rounding picks between near-equal logits, a fault need not;
    - ``forced_mismatches``: first mismatches at forced ticks, where both
      must carry the ground truth;
    - ``early_changed``: the share of logits that differ at all in the first
      ``early_ticks`` ticks. In bf16 two versions that round the same
      values differ there only where a sum's order flipped a rounding,
      which is rare; a value rounded elsewhere (a carry kept in f32) changes
      most logits from the second tick on. Over the whole sequence such
      flips cascade, and the two cannot be told apart by the logits' size.

    :param got, want: (logits (B, T, V), tokens (B, T)) each
    """
    (lg_a, tok_a), (lg_b, tok_b) = got, want
    same = tok_a == tok_b
    run = torch.cumprod(same.int(), dim=1)
    seen = torch.cat([torch.ones_like(run[:, :1]), run[:, :-1]], dim=1).bool()
    d = (lg_a.float() - lg_b.float()).abs()[seen]
    first = seen & ~same
    lg = lg_b.float()[first]
    top = lg.max(dim=-1).values if lg.numel() else lg.new_zeros(0)
    gap = torch.maximum(top - lg.gather(-1, tok_a[first].long()[:, None])[:, 0],
                        top - lg.gather(-1, tok_b[first].long()[:, None])[:, 0])
    early = (lg_a[:, :early_ticks] != lg_b[:, :early_ticks])[seen[:, :early_ticks]]
    return {"tokens": same.float().mean().item(), "logits_max": d.max().item(),
            "logits_mean": d.mean().item(), "tie_gap": gap.max().item() if gap.numel() else 0.0,
            "forced_mismatches": int((first & (force_mask > 0)).sum().item()),
            "early_changed": early.float().mean().item()}


def within(agreement: dict, bounds: dict) -> bool:
    """``decode_agreement`` inside ``bounds`` (``tokens``, ``max``, ``mean``,
    and ``early`` where given): a token share, the logits' max and mean, the
    tie gap within the max, no mismatch at a forced tick, and the share of
    early logits changed."""
    a = agreement
    return (a["tokens"] >= bounds["tokens"] and a["logits_max"] <= bounds["max"]
            and a["logits_mean"] <= bounds["mean"] and a["tie_gap"] <= bounds["max"]
            and a["forced_mismatches"] == 0
            and a["early_changed"] <= bounds.get("early", 1.0))
