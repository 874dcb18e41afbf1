"""K2: the hierarchical decoder's 24-tick argmax sampling decode.

``decode_sampling`` is the CUDA kernel ``csrc/decode_sampling.cu`` (it
replaces the TPU kernel ``inpaintnet_tpu/ops/decode_pallas.py
decode_sampling_pallas``; the source says what bounds it on the card and
how its design answers). Its bf16 route is the Hopper design of
``csrc/decode_hopper.cuh``: :func:`launch_plan` picks how many CTAs of a
cluster split the units of each 64-row tile, and the packed weights, their
tensor map and the stacked biases are built once per set of weight tensors
(:func:`decode_operands`). Its f32 route (``decode_hopper.cuh
decode_f32_kernel``) runs the same tick chain with every product as six
bf16 ``wgmma`` passes over exact pieces, h's pieces exchanged through an L2
scratch (:func:`f32_plan`; the weight pieces :func:`pack_decode_f32_weights`,
the init hiddens' pieces :func:`decode_f32_data`).
``decode_sampling_reference`` is its plain PyTorch version with the same
numerics: products accumulate in f32, biases and gates in f32, both
carries are rounded to the parameter dtype every tick, the fed-back row is
a row of the parameter-dtype token table, the argmax runs on the f32
logits (first index among equal maxima), and the logits are returned in
the parameter dtype. :func:`tick_product`, :func:`layer1_preacts` and
:func:`beat_operand` hold the steps a kernel is most likely to get wrong,
so a check can plant a fault there.

The products around the loop (token table, tick-0 input, beat-context
projection) are computed outside the kernel by ``decode_inputs``, as the
TPU kernel's are.

``decode_sampling_int8`` (K4, ``csrc/decode_sampling_int8.cu``) is the int8
serving twin (``decode_sampling_pallas_int8``), with
``decode_sampling_int8_reference`` as its plain version. It runs the same
Hopper design on s8 ``wgmma`` (int8 h tiles and slabs with the 64-byte
swizzle; :func:`int8_plan`) for bf16 and f32 masters, bit-equal to its
plain version. Its operands come in two parts: the quantized weights,
scales, packed slabs and tensor map, built once per set of weight tensors
(:func:`decode_int8_weights`), and each call's row scales, quantized init
hiddens and beat context (:func:`decode_int8_data`).

Both take every width up to 512, and in bf16 masters up to 717
(:func:`decode_supports`, ``kernel_common.decode_width``): a width no plan
takes runs at the next one that one does (whole 64-unit blocks; above 512
one that K2's and K4's clusters split and whose rings fit, so 641-717 run
at 768), on zero units (:func:`decode_padded_operands`); the logits and
samples need no slicing. Above 512 units the plans take an odd cluster (3
CTAs at 576) and boxes of one k-slab or, K2 at 768, half of one
(``kernel_common.decode_box_halves``, :func:`slab_map`).

The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch the kernel or raise.
"""
from __future__ import annotations

import torch

import ctypes
import functools

from inpaintnet_tpu_torch.ops import kernel_common
from inpaintnet_tpu_torch.ops.kernel_common import (
    CELL_KEYS,
    DTYPE_CODES,
    HOPPER_ROWS,
    HOPPER_SMEM_BUDGET,
    LaunchPlan,
    WeightCache,
    check_cuda_tensor,
    check_launch,
    counts_launches,
    decode_cluster_sizes,
    decode_stages,
    decode_width,
    fitting_clusters,
    gru_gates_f32,
    least_cost_cluster,
    load_kernels,
    pad_cell,
    pad_units,
    padded_cache,
    recurrence_slots,
    split_bf16_pieces,
    split_blocks,
    stream_ptr,
)
from inpaintnet_tpu_torch.ops.encoder_kernel import pack_gate_blocks
from inpaintnet_tpu_torch.ops.quantize import dequantize_h, quantize_cols_int8, quantize_h_int8

NUM_TICKS = 24
TICKS_PER_BEAT = 6
HEAD_COLS = 96  # columns of a head chunk of the Hopper routes (48 a warpgroup)
# K2 f32 against its plain version on the card (and a split emulation
# against the plain version and the JAX kernel on the CPU): tokens equal on
# >= 99.99% (argmax near-ties), logits within 1e-5 where both decodes fed
# back the same tokens (both sum in f32, in other orders)
F32_BOUNDS = {"tokens": 0.9999, "logits": 1e-5}


def _ctx_xw(params, tick_ctx: torch.Tensor) -> torch.Tensor:
    """(4, B, 3H) = tick_ctx @ W_ih0[E:] + b_ih0 in the parameter dtype,
    beat-major."""
    p0 = params["tick_gru"][0][0]
    E = params["embedding"]["table"].shape[1]
    ctx_xw = (tick_ctx.float() @ p0["w_ih"][E:].float()).to(p0["w_hh"].dtype) + p0["b_ih"]
    return ctx_xw.transpose(0, 1).contiguous()


def narrow_ctx_xw(params, tick_ctx: torch.Tensor, padded: int) -> torch.Tensor:
    """The beat context's projection (``decode_inputs``' ``ctx_xw``) of the
    decoder at its own width H, with zero units up to ``padded``: what the
    wrappers hand a launch at the padded width, so that its one product of
    real values over H (the only sum of the data part that is not exact)
    is the plain version's, bit for bit. Taken at the padded depth, cuBLAS
    may block it otherwise (a bf16 rounding of it moved K4's logits at 704
    on 768 units, NVIDIA H100 80GB HBM3)."""
    return pad_units(_ctx_xw(params, tick_ctx), tick_ctx.shape[2], padded, 3)


def _at_width(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor) -> tuple:
    """What K2's and K4's wrappers launch on: at ``decode_width(H)`` on zero
    units (:func:`decode_padded_operands`) with the beat context's
    projection taken at H (:func:`narrow_ctx_xw`) where the plans do not
    take H, else the operands as they are (the projection None: computed
    from them). -> (params, tick_ctx, h_inits, ctx_xw)"""
    padded = decode_width(tick_ctx.shape[2], tick_ctx.dtype)
    if padded in (None, tick_ctx.shape[2]):
        return params, tick_ctx, h_inits, None
    return (*decode_padded_operands(params, tick_ctx, h_inits),
            narrow_ctx_xw(params, tick_ctx, padded))


def decode_inputs(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor, ctx_xw=None) -> dict:
    """The loop's precomputed operands, all in the parameter dtype:
    ``tok_tab`` (V, 3H) = emb @ W_ih0[:E]; ``x0_xw`` (3H,) = x_0 @ W_ih0[:E];
    ``ctx_xw`` (4, B, 3H) = tick_ctx @ W_ih0[E:] + b_ih0 (unless given:
    :func:`narrow_ctx_xw`); ``hi0``/``hi1`` (4, B, H) beat-major init
    hiddens."""
    p0 = params["tick_gru"][0][0]
    dtype = p0["w_hh"].dtype
    emb = params["embedding"]["table"]
    w_tok = p0["w_ih"][:emb.shape[1]].float()
    return {
        "tok_tab": (emb.float() @ w_tok).to(dtype),
        "x0_xw": (params["x_0"].float() @ w_tok).to(dtype),
        "ctx_xw": _ctx_xw(params, tick_ctx) if ctx_xw is None else ctx_xw,
        "hi0": h_inits[0].transpose(0, 1).contiguous(),
        "hi1": h_inits[1].transpose(0, 1).contiguous(),
    }


def agreement(got, want) -> dict:
    """(logits, samples) of K2 against its plain version's: the share of
    equal tokens, and the logits' max and mean absolute error up to each
    row's first token mismatch (both decodes fed back the same tokens
    there; past it the two rows are not comparable)."""
    same = (got[1] == want[1]).int()
    seen = torch.cat([torch.ones_like(same[:, :1]), torch.cumprod(same, 1)[:, :-1]], 1).bool()
    err = (got[0].float() - want[0].float()).abs()[seen]
    return {"tokens": same.float().mean().item(), "logits": err.max().item(),
            "mean": err.mean().item()}


def within(agree: dict, bound: dict = F32_BOUNDS) -> bool:
    """Tokens equal on at least ``bound["tokens"]``, logits within
    ``bound["logits"]``."""
    return agree["tokens"] >= bound["tokens"] and agree["logits"] <= bound["logits"]


def tick_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The products on a tick's h (layer 0's on h0, layer 1's on h0' and
    h1, the head's on h1'): h in f32 @ f32 ``w`` (one place, so a check can
    plant h taken as one bf16 piece, or the split arithmetic)."""
    return h.float() @ w


def layer1_preacts(x: torch.Tensor, h: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor):
    """Layer 1's two pre-activations from its products: (x + b_ih1, h +
    b_hh1), each in its own sum (one place, so a check can plant the two
    products summed in one accumulator)."""
    return x + b_ih, h + b_hh


def one_accumulator_preacts(x: torch.Tensor, h: torch.Tensor, b_ih: torch.Tensor,
                            b_hh: torch.Tensor):
    """The planted fault of :func:`layer1_preacts` "layer 1's x- and
    h-products in one accumulator": the r and z columns summed ((x + h) +
    b_ih1) + b_hh1 (hw's part zero), the n column's products apart (r
    multiplies h's). In f32 it moves layer 1 by a rounding only; on
    :func:`cancelling_layer1_biases` the rounding shows."""
    hidden = x.shape[1] // 3
    rz = ((x[:, :2 * hidden] + h[:, :2 * hidden]) + b_ih[:2 * hidden]) + b_hh[:2 * hidden]
    return (torch.cat([rz, x[:, 2 * hidden:] + b_ih[2 * hidden:]], 1),
            torch.cat([torch.zeros_like(rz), h[:, 2 * hidden:] + b_hh[2 * hidden:]], 1))


def cancelling_layer1_biases(params, shift: float):
    """The decoder's params with layer 1's biases moved by +shift (b_ih1)
    and -shift (b_hh1): the same function, on which the plain version's sum
    order (x + b_ih1) + (h + b_hh1) and :func:`one_accumulator_preacts`'
    round apart by up to half an ulp of ``shift`` (a check's input, not a
    model's)."""
    p1 = dict(params["tick_gru"][1][0])
    p1["b_ih"], p1["b_hh"] = p1["b_ih"] + shift, p1["b_hh"] - shift
    return {**params, "tick_gru": [params["tick_gru"][0], [p1]]}


# On cancelling_layer1_biases(params, SUM_ORDER_SHIFT) the fault
# one_accumulator_preacts moves the mean logit error (against the plain
# version) to at least SUM_ORDER_RATIO times a correct kernel's (the split
# emulation on the CPU: 35-41x; PERF.md has the card's readings)
SUM_ORDER_SHIFT = 1024.0
SUM_ORDER_RATIO = 8.0


def beat_operand(init: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The operand of a reset tick's product on h (t % 6 == 0, t > 0): the
    beat's init hidden, not ``prev``, the h of the tick before (one place,
    so a check can plant the latter)."""
    return init


def decode_sampling_reference(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor):
    """Plain version of K2.

    :param params: HierarchicalDecoder params (2 tick-GRU layers)
    :param tick_ctx: (B, 4, H) per-beat context; h_inits: (2, B, 4, H)
    :return: (logits (B, 24, V) in the parameter dtype, samples (B, 24) int32)
    """
    p0, p1 = params["tick_gru"][0][0], params["tick_gru"][1][0]
    dtype = p0["w_hh"].dtype
    hidden = p0["w_hh"].shape[0]
    ins = decode_inputs(params, tick_ctx, h_inits)
    f = {k: v.float() for k, v in (("whh0", p0["w_hh"]), ("bhh0", p0["b_hh"]),
                                   ("wih1", p1["w_ih"]), ("bih1", p1["b_ih"]),
                                   ("whh1", p1["w_hh"]), ("bhh1", p1["b_hh"]),
                                   ("head_w", params["head"]["w"]),
                                   ("head_b", params["head"]["b"]))}
    prev = ins["x0_xw"].float().expand(tick_ctx.shape[0], -1)
    logits, samples = [], []
    for t in range(NUM_TICKS):
        beat = t // TICKS_PER_BEAT
        if t % TICKS_PER_BEAT:
            op0, op1 = h0, h1
        elif t == 0:
            op0, op1 = h0, h1 = ins["hi0"][beat], ins["hi1"][beat]
        else:
            op0, op1 = beat_operand(ins["hi0"][beat], h0), beat_operand(ins["hi1"][beat], h1)
            h0, h1 = ins["hi0"][beat], ins["hi1"][beat]
        xw0 = prev + ins["ctx_xw"][beat].float()
        hw0 = tick_product(op0, f["whh0"]) + f["bhh0"]
        h0 = gru_gates_f32(xw0, hw0, h0.float(), hidden).to(dtype)
        xw1, hw1 = layer1_preacts(tick_product(h0, f["wih1"]), tick_product(op1, f["whh1"]),
                                  f["bih1"], f["bhh1"])
        h1 = gru_gates_f32(xw1, hw1, h1.float(), hidden).to(dtype)
        lg = torch.relu(tick_product(h1, f["head_w"]) + f["head_b"])
        s = torch.argmax(lg, dim=-1)  # first index among equal maxima
        prev = ins["tok_tab"][s].float()
        logits.append(lg.to(dtype))
        samples.append(s)
    return torch.stack(logits, dim=1), torch.stack(samples, dim=1).to(torch.int32)


def _check_decode_args(name: str, params, tick_ctx: torch.Tensor, h_inits: torch.Tensor):
    """The K2/K4 wrappers' checks of what the kernels take. -> (batch,
    hidden, vocab, parameter dtype, device); raises ValueError otherwise."""
    if len(params["tick_gru"]) != 2:
        raise ValueError(f"{name}: takes a 2-layer tick GRU")
    p0, p1 = params["tick_gru"][0][0], params["tick_gru"][1][0]
    device, dtype = tick_ctx.device, p0["w_hh"].dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {dtype}")
    batch, num_beats, hidden = tick_ctx.shape
    kind = "int8" if name.endswith("int8") else dtype
    if (num_beats != NUM_TICKS // TICKS_PER_BEAT or decode_width(hidden, dtype) != hidden
            or not decode_supports(hidden, kind, dtype)):
        raise ValueError(f"{name}: no kernel for (beats, hidden) {(num_beats, hidden)}")
    check_cuda_tensor("tick_ctx", tick_ctx, (batch, num_beats, hidden), dtype, device)
    check_cuda_tensor("h_inits", h_inits, (2, batch, num_beats, hidden), dtype, device)
    for tag, w in (("tick_gru0.w_hh", p0["w_hh"]), ("tick_gru1.w_ih", p1["w_ih"]),
                   ("tick_gru1.w_hh", p1["w_hh"])):
        check_cuda_tensor(tag, w, (hidden, 3 * hidden), dtype, device)
    for tag, b in (("tick_gru0.b_hh", p0["b_hh"]), ("tick_gru1.b_ih", p1["b_ih"]),
                   ("tick_gru1.b_hh", p1["b_hh"])):
        check_cuda_tensor(tag, b, (3 * hidden,), dtype, device)
    vocab = params["head"]["w"].shape[1]
    check_cuda_tensor("head.w", params["head"]["w"], (hidden, vocab), dtype, device)
    check_cuda_tensor("head.b", params["head"]["b"], (vocab,), dtype, device)
    return batch, hidden, vocab, dtype, device


def launch_plan(rows: int, hidden: int, sms: int, slots=None) -> LaunchPlan:
    """How K2's bf16 route runs ``rows`` decode rows at ``hidden`` units on a
    card of ``sms`` SMs: the cluster size of ``kernel_common.
    least_cost_cluster`` among ``decode_cluster_sizes`` (CTAs sharing a
    64-row tile, each computing ``hidden / cluster`` units of both layers)
    and the ring depth beside the two h tiles (``decode_stages``; ``slots``:
    the clusters of each size the card runs at once). Up to 512 units it is
    ``kernel_common.recurrence_plan``'s. Raises ValueError for a width no
    plan takes."""
    sizes, stages = decode_cluster_sizes(hidden), decode_stages(hidden, 2, 2)
    if not sizes or stages < 2:
        raise ValueError(f"no K2 plan for hidden size {hidden}")
    return LaunchPlan(least_cost_cluster(rows, sizes, sms, slots), stages)


def card_plan(rows: int, hidden: int, device) -> LaunchPlan:
    """:func:`launch_plan` on the card ``device`` names, with its own SM
    count and cluster slots: the plan :func:`decode_sampling` launches."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    slots = recurrence_slots("inpaint_decode_slots", hidden, decode_stages(hidden, 2, 2), index,
                             tuple(decode_cluster_sizes(hidden)))
    return launch_plan(rows, hidden, torch.cuda.get_device_properties(index).multi_processor_count,
                       slots)


def head_chunks(vocab: int) -> int:
    """Chunks of the Hopper routes' head: the vocabulary zero-padded to
    whole chunks of ``HEAD_COLS``, one at the flagship's V 60. Each CTA
    walks them all with a running argmax (``csrc/decode_hopper.cuh
    head_chunk``)."""
    return -(-vocab // HEAD_COLS)


def _padded_head(head_w: torch.Tensor, dtype) -> torch.Tensor:
    """The head's W^T, (chunks * 96, H), zero rows past V."""
    hidden, vocab = head_w.shape
    head = torch.zeros((head_chunks(vocab) * HEAD_COLS, hidden), dtype=dtype,
                       device=head_w.device)
    head[:vocab] = head_w.t()
    return head


# --------------------------------------------------------------------------- #
# K2's f32 route (csrc/decode_hopper.cuh decode_f32_kernel)
# --------------------------------------------------------------------------- #
F32_UNITS = 16  # units of a chunk: its r, z, n rows are one 64 x 48 wgmma tile
F32_BLOCK_BYTES = 3 * F32_UNITS * 128  # a 48 x 64 bf16 block of packed weight pieces
F32_STAGE_BYTES = 3 * HOPPER_ROWS * 128 + 6 * F32_BLOCK_BYTES  # the operand's pieces + two chunks'
F32_MAX_STAGES = 4
F32_CARRY_PAD = 8  # f32 padding of the carries' rows


def f32_smem_bytes(hidden: int, cluster: int, stages: int) -> int:
    """Dynamic shared memory of an f32 K2 CTA (``decode_hopper.cuh
    decode_f32_smem_bytes``): the ring's 60 KB stages (a k-slab of the
    operand's three pieces and of two chunks' three weight pieces) and the
    f32 carries of its ``hidden / cluster`` units, both layers."""
    return (stages * F32_STAGE_BYTES
            + 2 * HOPPER_ROWS * (hidden // cluster + F32_CARRY_PAD) * 4 + 1024)


def f32_stages(hidden: int, cluster: int) -> int:
    """Ring stages of an f32 K2 CTA beside its carries: 3 at H 512 with 8
    CTAs a tile, 2 with 4."""
    free = HOPPER_SMEM_BUDGET - f32_smem_bytes(hidden, cluster, 0)
    return min(F32_MAX_STAGES, free // F32_STAGE_BYTES)


def f32_cluster_sizes(hidden: int) -> list:
    """Cluster sizes the f32 route takes: CTAs owning whole pairs of 16-unit
    chunks (32 units a round, one chunk a consumer warpgroup) with a ring of
    at least two stages beside their f32 carries: 4 and 8 at the flagship's
    H 512 (at 2 the carries of 256 units leave one stage); 7 at H 448, where
    no power of two fits (``kernel_common.fitting_clusters``)."""
    if hidden % 64 or hidden <= 0:
        return []
    return fitting_clusters(lambda c: hidden % c == 0 and (hidden // c) % 32 == 0
                            and f32_stages(hidden, c) >= 2)


def f32_plan(rows: int, hidden: int, sms: int, slots=None) -> LaunchPlan:
    """How the f32 route runs ``rows`` rows: the cluster size of
    ``kernel_common.least_cost_cluster`` among :func:`f32_cluster_sizes`
    (a CTA's chain of rounds shrinks as 1/C), with its ring depth. Raises
    ValueError for a width no size takes."""
    sizes = f32_cluster_sizes(hidden)
    if not sizes:
        raise ValueError(f"no f32 K2 plan for hidden size {hidden}")
    cluster = least_cost_cluster(rows, sizes, sms, slots)
    return LaunchPlan(cluster, f32_stages(hidden, cluster))


@functools.lru_cache(maxsize=None)
def f32_slots(hidden: int, device_index: int) -> dict:
    """{C: clusters of C CTAs of the f32 route the card runs at once},
    asked once per width and card."""
    with torch.cuda.device(device_index):
        counts = {c: load_kernels().inpaint_decode_f32_slots(hidden, c, f32_stages(hidden, c))
                  for c in f32_cluster_sizes(hidden)}
    bad = sorted(c for c, n in counts.items() if n < 1)
    if bad:
        raise RuntimeError(f"decode_sampling: the card runs no f32 cluster of sizes {bad} at "
                           f"hidden size {hidden}")
    return counts


def f32_card_plan(rows: int, hidden: int, device) -> LaunchPlan:
    """:func:`f32_plan` on the card ``device`` names, with its own SM count
    and cluster slots: the plan :func:`decode_sampling` launches in f32."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return f32_plan(rows, hidden, torch.cuda.get_device_properties(index).multi_processor_count,
                    f32_slots(hidden, index))


def pack_decode_f32_weights(w_hh0, w_ih1, w_hh1, head_w) -> torch.Tensor:
    """The f32 route's weights as one array of (48, 64) bf16 blocks (6 KB),
    each weight's three pieces (``kernel_common.split_bf16_pieces``), in
    the order the recurrence streams them (``kernel_common.split_blocks``):
    W_hh0, W_ih1 and W_hh1 by pairs of 16-unit chunks, row 16 g + u of chunk
    c the weight's column g H + 16 c + u; then the head's W^T, its columns
    zero-padded to whole chunks of 96 (:func:`head_chunks`), each chunk one
    pair of 48."""
    hidden = head_w.shape[0]

    def gru(w):
        wt = w.float().t().reshape(3, hidden // F32_UNITS, F32_UNITS, hidden)
        wt = wt.permute(1, 0, 2, 3).reshape(3 * hidden, hidden)
        return split_blocks(torch.stack(split_bf16_pieces(wt)), 3 * F32_UNITS)

    head = _padded_head(head_w.float(), torch.float32)
    return torch.cat([gru(w_hh0), gru(w_ih1), gru(w_hh1),
                      split_blocks(torch.stack(split_bf16_pieces(head)), HEAD_COLS // 2)]) \
        .contiguous()


def f32_map(packed: torch.Tensor):
    """The tensor map (a 128-byte CUtensorMap, in a host buffer) of the
    packed (blocks, 48, 64) bf16 weight pieces, six blocks a box. ->
    (buffer, its aligned address); keep ``packed`` alive as long as the
    map."""
    buf = ctypes.create_string_buffer(128 + 64)
    addr = (ctypes.addressof(buf) + 63) // 64 * 64
    check_launch(load_kernels().inpaint_decode_f32_map(packed.data_ptr(), packed.shape[0], addr),
                 "decode_f32_map")
    return buf, addr


def decode_f32_data(h_inits: torch.Tensor) -> torch.Tensor:
    """The f32 route's per-call operand: the init hiddens' three bf16
    pieces, (2 layers, 4 beats, 3 pieces, rows, H) with the rows zero-padded
    to whole 64-row tiles, which a reset tick's products read instead of the
    previous tick's pieces."""
    layers, batch, beats, hidden = h_inits.shape
    rows = -(-batch // HOPPER_ROWS) * HOPPER_ROWS
    hi = torch.nn.functional.pad(h_inits.float().transpose(1, 2), (0, 0, 0, rows - batch))
    return torch.stack(split_bf16_pieces(hi), dim=2).contiguous()


def pack_decode_weights(w_hh0, w_ih1, w_hh1, head_w) -> torch.Tensor:
    """K2's bf16 or K4's int8 weights as one array of (96, 64) k-slabs,
    (3 H / 32 + chunks, H / 64, 96, 64): W_hh0, W_ih1 and W_hh1 as
    ``pack_gate_blocks`` lays them out, then the head's W^T as
    :func:`head_chunks` more chunks (row r of head chunk c its column 96 c +
    r, zero rows past V). A k-slab row is 64
    values of K in either type: 128 bytes of bf16 (the 128-byte swizzle) or
    64 of int8 (the 64-byte swizzle, which the 8-bit ``wgmma``'s K-major
    operands need for 64-unit h blocks)."""
    hidden = head_w.shape[0]
    head = _padded_head(head_w, head_w.dtype)
    head = head.reshape(-1, HEAD_COLS, hidden // 64, 64).permute(0, 2, 1, 3)
    return torch.cat([pack_gate_blocks(w) for w in (w_hh0, w_ih1, w_hh1)] + [head]).contiguous()


def _head_pad(vocab: int) -> tuple:
    """``F.pad``'s padding of a (V,) head vector to whole chunks."""
    return (0, head_chunks(vocab) * HEAD_COLS - vocab)


def decode_supports(hidden: int, dtype, masters=None) -> bool:
    """Whether K2's route in ``dtype`` (K4's for ``"int8"``) has a plan at
    the width it runs ``hidden`` at in masters of ``masters`` (by default
    ``dtype``, and bf16, K4's widest, for ``"int8"``), ``decode_width``
    (:func:`decode_padded_operands`): every width up to 512 does, and in
    bf16 every one up to 768, at every vocabulary (the head is a loop over
    chunks, :func:`head_chunks`). With ``HierarchicalDecoder.use_kernel``
    (``kernel_common.decode_supports_hidden``: bf16 up to 717) this is K2's
    and K4's gate."""
    masters = masters or (torch.bfloat16 if dtype == "int8" else dtype)
    hidden = decode_width(hidden, masters)
    if hidden is None:
        return False
    if dtype == "int8" or dtype == torch.bfloat16:
        h_tiles, elem = (4, 1) if dtype == "int8" else (2, 2)
        return bool(decode_cluster_sizes(hidden)) and decode_stages(hidden, h_tiles, elem) >= 2
    return dtype == torch.float32 and bool(f32_cluster_sizes(hidden))


def _build_padded_decoder(*weights, padded: int) -> dict:
    """The tick GRU and head of ``weights`` (layer 0's and layer 1's
    ``CELL_KEYS``, then the head's w and b) at ``padded`` units."""
    hidden = weights[1].shape[0]
    p0, p1 = (dict(zip(CELL_KEYS, weights[4 * i:4 * i + 4])) for i in range(2))
    emb_dim = p0["w_ih"].shape[0] - hidden

    def unit_rows(w):  # an input of H units: the beat context, h0', h1'
        return pad_units(w, hidden, padded, dim=0)

    def ctx_rows(w):  # layer 0 reads [token embedding E | beat context H]
        return torch.cat([w[:emb_dim], unit_rows(w[emb_dim:])])
    return {"tick_gru": [[pad_cell(p0, hidden, padded, 3, ctx_rows)],
                         [pad_cell(p1, hidden, padded, 3, unit_rows)]],
            "head": {"w": unit_rows(weights[8]), "b": weights[9]}}


# K2's and K4's decoder at the width they run it at, built once per set of
# weight tensors
padded_decoder = padded_cache(_build_padded_decoder)


def decode_padded_operands(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor,
                           padded=None) -> tuple:
    """K2's and K4's operands at ``decode_width(H)`` units (or ``padded``):
    the tick GRU with zero units (``kernel_common.pad_cell``: layer 0's W_ih
    rows of the beat context, layer 1's W_ih rows, the head's input rows),
    the beat context and the (SELU'd beat-to-tick) init hiddens with zero
    units. The token table, ``x_0`` and the head's columns are unchanged, so
    the logits and samples are the narrow decoder's: no slicing. K4's
    per-row bound and column scales see only zeros more. -> (params,
    tick_ctx, h_inits)"""
    hidden = tick_ctx.shape[2]
    p0, p1 = params["tick_gru"][0][0], params["tick_gru"][1][0]
    padded = padded or decode_width(hidden, p0["w_hh"].dtype)
    narrow = padded_decoder(*(p[k] for p in (p0, p1) for k in CELL_KEYS), params["head"]["w"],
                            params["head"]["b"], padded=padded)
    return ({**narrow, "embedding": params["embedding"], "x_0": params["x_0"]},
            pad_units(tick_ctx, hidden, padded), pad_units(h_inits, hidden, padded))


def slab_map(packed: torch.Tensor):
    """The tensor map (a 128-byte CUtensorMap, in a host buffer) of K2's
    bf16 or K4's int8 packed weights (:func:`pack_decode_weights`), boxes of
    ``kernel_common.decode_box_halves`` halves of a k-slab (``csrc/
    decode_hopper.cuh make_decode_map``). Keep ``packed`` alive as long as
    the map."""
    buf = ctypes.create_string_buffer(128 + 64)
    addr = (ctypes.addressof(buf) + 63) // 64 * 64
    int8 = packed.dtype == torch.int8
    check_launch(load_kernels().inpaint_decode_map(
        packed.data_ptr(), packed.shape[0] * packed.shape[1], packed.shape[1] * 64, int(int8),
        addr), "decode slab_map")
    return buf, addr


def _build_decode_operands(w_hh0, w_ih1, w_hh1, head_w, b_hh0, b_ih1, b_hh1, head_b):
    head_b = torch.nn.functional.pad(head_b, _head_pad(head_b.shape[0]))
    bias = torch.stack([b_hh0, b_ih1, b_hh1])
    if head_w.dtype == torch.bfloat16:
        packed = pack_decode_weights(w_hh0, w_ih1, w_hh1, head_w)
        buf, addr = slab_map(packed)
    else:
        packed = pack_decode_f32_weights(w_hh0, w_ih1, w_hh1, head_w)
        buf, addr = f32_map(packed)
    return {"packed": packed, "map": buf, "map_addr": addr, "head_b": head_b, "bias": bias}


# K2's per-weight operands, built once per set of weight tensors
decode_operands = WeightCache(_build_decode_operands)


@counts_launches  # proves a run went through K2
def decode_sampling(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor):
    """K2: argmax decode of one measure per row.

    :param params: HierarchicalDecoder params, (in, out) weights, f32 or bf16,
        any vocabulary (the head runs in chunks of ``HEAD_COLS``)
    :param tick_ctx: (B, 4, H) per-beat context (selu'd beat_to_tick_input)
    :param h_inits: (2, B, 4, H) per-beat tick-GRU init hiddens
    :return: (logits (B, 24, V) in the parameter dtype, samples (B, 24) int32)
    """
    if tick_ctx.device.type == "cpu":
        return decode_sampling_reference(params, tick_ctx, h_inits)
    if tick_ctx.device.type != "cuda":
        raise ValueError(f"decode_sampling: no kernel for device {tick_ctx.device}")
    params, tick_ctx, h_inits, ctx_xw = _at_width(params, tick_ctx, h_inits)
    batch, hidden, vocab, dtype, device = _check_decode_args("decode_sampling", params,
                                                             tick_ctx, h_inits)
    p0, p1 = params["tick_gru"][0][0], params["tick_gru"][1][0]
    ops = decode_operands(p0["w_hh"], p1["w_ih"], p1["w_hh"], params["head"]["w"],
                          p0["b_hh"], p1["b_ih"], p1["b_hh"], params["head"]["b"])
    ins = decode_inputs(params, tick_ctx, h_inits, ctx_xw)
    logits = torch.empty((batch, NUM_TICKS, vocab), dtype=dtype, device=device)
    samples = torch.empty((batch, NUM_TICKS), dtype=torch.int32, device=device)
    lib = load_kernels()
    inputs = (ins["ctx_xw"].data_ptr(), ins["hi0"].data_ptr(), ins["hi1"].data_ptr(),
              ins["tok_tab"].data_ptr(), ins["x0_xw"].data_ptr())
    if dtype == torch.bfloat16:
        plan = card_plan(batch, hidden, device)
        err = lib.inpaint_decode_sampling_bf16(
            ops["map_addr"], *inputs, ops["bias"].data_ptr(), ops["head_b"].data_ptr(),
            logits.data_ptr(), samples.data_ptr(), batch, hidden, vocab, plan.cluster,
            plan.stages, kernel_common.head_ties(), stream_ptr())
    else:
        plan = f32_card_plan(batch, hidden, device)
        init = decode_f32_data(h_inits)
        # the exchange of h0's and h1's three pieces, by tick parity
        scratch = torch.empty((-(-batch // HOPPER_ROWS), 2, 2, 3, HOPPER_ROWS, hidden),
                              dtype=torch.bfloat16, device=device)
        err = lib.inpaint_decode_sampling_f32(
            ops["map_addr"], *inputs, ops["bias"].data_ptr(), ops["head_b"].data_ptr(),
            logits.data_ptr(), samples.data_ptr(), init.data_ptr(), scratch.data_ptr(), batch,
            hidden, vocab, plan.cluster, plan.stages, kernel_common.head_ties(), stream_ptr())
    check_launch(err, "decode_sampling")
    decode_sampling.launches += 1
    return logits, samples


# --------------------------------------------------------------------------- #
# K4: the int8 twin of K2
# --------------------------------------------------------------------------- #
def _int8_weights(w_hh0, w_ih1, w_hh1, head_w, emb, w_ih0, x_0, b_hh0, b_ih1, b_hh1, head_b):
    """K4's weight part (see :func:`decode_int8_operands`)."""
    E = emb.shape[1]
    w_tok = w_ih0[:E].float()
    out = {"x0_xw": (x_0.float() @ w_tok).to(w_hh0.dtype)}
    scales = []
    for name, w in (("whh0_q", w_hh0), ("wih1_q", w_ih1), ("whh1_q", w_hh1),
                    ("tok_q", emb.float() @ w_tok)):
        out[name], s = quantize_cols_int8(w)
        scales.append(s[0])
    out["scales"] = torch.stack(scales)
    out["head_q"], s_head = quantize_cols_int8(head_w)
    out["head_s"] = s_head[0]
    out["bias"] = torch.stack([b_hh0, b_ih1, b_hh1]).float()
    out["head_b"] = head_b.float()
    return out


def _int8_weight_tensors(params) -> tuple:
    """The weight tensors K4's weight part is built from, in
    :func:`_int8_weights`' order."""
    p0, p1 = params["tick_gru"][0][0], params["tick_gru"][1][0]
    return (p0["w_hh"], p1["w_ih"], p1["w_hh"], params["head"]["w"],
            params["embedding"]["table"], p0["w_ih"], params["x_0"], p0["b_hh"], p1["b_ih"],
            p1["b_hh"], params["head"]["b"])


def decode_int8_data(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor,
                     ctx_xw=None) -> dict:
    """K4's data part, built on every call (see :func:`decode_int8_operands`):
    ``q``, ``hi0``, ``hi1`` and ``ctx_xw`` (unless given:
    :func:`narrow_ctx_xw`)."""
    bound = torch.clamp_min(h_inits.float().abs().amax(dim=(0, 2, 3)), 1.0)
    # a true division: ``127.0 / bound`` would be ``reciprocal(bound) * 127``;
    # the numerator made on the device (a host tensor's copy would not capture)
    q = torch.div(torch.full_like(bound, 127.0), bound)
    return {"q": q, "ctx_xw": _ctx_xw(params, tick_ctx) if ctx_xw is None else ctx_xw,
            "hi0": quantize_h_int8(h_inits[0], q[:, None, None]).transpose(0, 1).contiguous(),
            "hi1": quantize_h_int8(h_inits[1], q[:, None, None]).transpose(0, 1).contiguous()}


def decode_int8_operands(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor) -> dict:
    """K4's operands, computed outside the kernel as the TPU kernel's are
    (``decode_pallas.py:474-508``). The weight part (built once per set of
    weight tensors by the wrapper, :func:`decode_int8_weights`):

    - ``x0_xw`` (3H,): as K2's, in the parameter dtype;
    - ``tok_q`` (V, 3H) int8: the token table ``emb @ W_ih0[:E]`` taken in
      f32 and quantized;
    - ``whh0_q``, ``wih1_q``, ``whh1_q`` (H, 3H), ``head_q`` (H, V) int8;
    - ``scales`` (4, 3H) f32: the column scales of W_hh0, W_ih1, W_hh1 and
      the token table; ``head_s`` (V,) f32;
    - ``bias`` (3, 3H) f32: b_hh0, b_ih1, b_hh1; ``head_b`` (V,) f32.

    The data part (built on every call, :func:`decode_int8_data`):

    - ``q`` (B,) f32: each row's hidden scale ``127 / bound`` with
      ``bound = max(1, max|h_inits[:, row]|)`` over both layers and all four
      beats. The bound is per row, never over the batch, so a row's tokens
      depend on its own inputs only (solo == coalesced, bit for bit);
    - ``hi0``/``hi1`` (4, B, H) int8: the beat-major init hiddens quantized
      at their row's ``q``;
    - ``ctx_xw`` (4, B, 3H): as K2's, in the parameter dtype.
    """
    return {**_int8_weights(*_int8_weight_tensors(params)),
            **decode_int8_data(params, tick_ctx, h_inits)}


def _build_decode_int8_weights(*weights) -> dict:
    ops = _int8_weights(*weights)
    pad = _head_pad(ops["head_q"].shape[1])
    packed = pack_decode_weights(ops["whh0_q"], ops["wih1_q"], ops["whh1_q"], ops["head_q"])
    buf, addr = slab_map(packed)
    return {**ops, "packed": packed, "map": buf, "map_addr": addr,
            "head_s_pad": torch.nn.functional.pad(ops["head_s"], pad),
            "head_b_pad": torch.nn.functional.pad(ops["head_b"], pad)}


# K4's weight part with its packed int8 slabs, their tensor map and the
# head's scales and bias padded to whole chunks, built once per set of
# weight tensors
decode_int8_weights = WeightCache(_build_decode_int8_weights)


def int8_plan(hidden: int) -> LaunchPlan:
    """How K4 runs ``hidden`` units, whatever the rows: the largest cluster
    size (the fewest units a CTA) and the ring depth beside its four int8 h
    tiles (each layer's double-buffered; together K2's two tiles' bytes).
    Unlike K2's, whose plan weighs
    waves of clusters against units a CTA, a K4 CTA's step chain grows
    faster than its units (its layers' registers spill more with more
    chunks a warpgroup): on an H100 at H 512, 8 CTAs a tile beat 2 and 4 at
    12,288 rows, and every other size at 2,048 and 6, on both masters
    (PERF.md). Above 512 units: 3 at 576, 2 at 640, 4 at 768
    (``kernel_common.decode_cluster_sizes``). Raises ValueError for a width
    no cluster size splits."""
    sizes = decode_cluster_sizes(hidden)
    stages = decode_stages(hidden, 4, 1)
    if not sizes or stages < 2:
        raise ValueError(f"no K4 plan for hidden size {hidden}")
    return LaunchPlan(max(sizes), stages)


def fed_back_xw(ops: dict, tok: torch.Tensor, dtype) -> torch.Tensor:
    """K4's fed-back token projection ``tok_q[tok] * s_tok`` in f32, rounded
    to the parameter dtype (the TPU kernel keeps it in scratch of that
    dtype), as f32."""
    return (ops["tok_q"][tok].float() * ops["scales"][3]).to(dtype).float()


def decode_sampling_int8_reference(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor):
    """Plain version of K4. Per tick: every product int8 x int8 summed
    exactly (int8 values held in f32, TF32 off), dequantized as
    ``(acc * column scale) * (1 / q[row])`` plus the f32 bias; the gates in
    f32; both carries stored as ``round(h * q[row])`` in int8. The logits
    are ``relu(acc * head_s * dq + head_b)`` in f32, the argmax takes the
    first index among equal maxima, and the fed-back token's projection is
    ``tok_q[token] * s_tok`` rounded to the parameter dtype (the TPU
    kernel's scratch dtype) before the next tick adds ``ctx_xw``.

    :return: (logits (B, 24, V) in the parameter dtype, samples (B, 24) int32)
    """
    dtype = params["tick_gru"][0][0]["w_hh"].dtype
    hidden = tick_ctx.shape[2]
    ops = decode_int8_operands(params, tick_ctx, h_inits)
    q = ops["q"][:, None]
    dq = 1.0 / q
    s, b = ops["scales"], ops["bias"]
    whh0, wih1, whh1, head = (ops[k].float() for k in ("whh0_q", "wih1_q", "whh1_q", "head_q"))
    prev = ops["x0_xw"].float().expand(tick_ctx.shape[0], -1)
    logits, samples = [], []
    for t in range(NUM_TICKS):
        beat = t // TICKS_PER_BEAT
        if t % TICKS_PER_BEAT == 0:
            h0_q, h1_q = ops["hi0"][beat], ops["hi1"][beat]
        xw0 = prev + ops["ctx_xw"][beat].float()
        hw0 = (h0_q.float() @ whh0) * s[0] * dq + b[0]
        h0_q = quantize_h_int8(gru_gates_f32(xw0, hw0, dequantize_h(h0_q, q), hidden), q)
        xw1 = (h0_q.float() @ wih1) * s[1] * dq + b[1]
        hw1 = (h1_q.float() @ whh1) * s[2] * dq + b[2]
        h1_q = quantize_h_int8(gru_gates_f32(xw1, hw1, dequantize_h(h1_q, q), hidden), q)
        lg = torch.relu((h1_q.float() @ head) * ops["head_s"] * dq + ops["head_b"])
        tok = torch.argmax(lg, dim=-1)  # first index among equal maxima
        prev = fed_back_xw(ops, tok, dtype)
        logits.append(lg.to(dtype))
        samples.append(tok)
    return torch.stack(logits, dim=1), torch.stack(samples, dim=1).to(torch.int32)


@counts_launches  # proves a run went through K4
def decode_sampling_int8(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor):
    """K4: ``decode_sampling`` with int8 products (``csrc/decode_sampling_int8.cu``,
    the Hopper design of ``csrc/decode_hopper.cuh`` on s8 ``wgmma``; it
    replaces ``inpaintnet_tpu/ops/decode_pallas.py
    decode_sampling_pallas_int8``). Same arguments and results as
    :func:`decode_sampling` (any vocabulary); the numerics are
    :func:`decode_sampling_int8_reference`'s, bit for bit. Per call it
    builds only the data part of its operands."""
    if tick_ctx.device.type == "cpu":
        return decode_sampling_int8_reference(params, tick_ctx, h_inits)
    if tick_ctx.device.type != "cuda":
        raise ValueError(f"decode_sampling_int8: no kernel for device {tick_ctx.device}")
    params, tick_ctx, h_inits, ctx_xw = _at_width(params, tick_ctx, h_inits)
    batch, hidden, vocab, dtype, device = _check_decode_args("decode_sampling_int8", params,
                                                             tick_ctx, h_inits)
    w = decode_int8_weights(*_int8_weight_tensors(params))
    d = decode_int8_data(params, tick_ctx, h_inits, ctx_xw)
    plan = int8_plan(hidden)
    logits = torch.empty((batch, NUM_TICKS, vocab), dtype=dtype, device=device)
    samples = torch.empty((batch, NUM_TICKS), dtype=torch.int32, device=device)
    err = load_kernels().inpaint_decode_sampling_int8(
        DTYPE_CODES[dtype], w["map_addr"], d["ctx_xw"].data_ptr(), d["hi0"].data_ptr(),
        d["hi1"].data_ptr(), d["q"].data_ptr(), w["tok_q"].data_ptr(), w["x0_xw"].data_ptr(),
        w["scales"].data_ptr(), w["bias"].data_ptr(), w["head_s_pad"].data_ptr(),
        w["head_b_pad"].data_ptr(), logits.data_ptr(), samples.data_ptr(), batch, hidden, vocab,
        plan.cluster, plan.stages, kernel_common.head_ties(), stream_ptr())
    check_launch(err, "decode_sampling_int8")
    decode_sampling_int8.launches += 1
    return logits, samples
