"""K8: one direction of a GRU layer over a precomputed input projection,
with hold masks: the generic layer of the ``"pallas"`` GRU route
(``ops/gru.py``).

``gru_layer_stream`` is the CUDA kernel ``csrc/gru_layer.cu``, which
replaces ``inpaintnet_tpu/ops/gru_pallas.py gru_layer_pallas_stream`` and the
two TPU kernels of the same function, ``gru_layer_pallas`` (K9) and
``gru_layer_pallas_dma`` (K10); the source says what bounds it on the card
and how its design answers. Its bf16 route is the Hopper design of
``csrc/gru_layer_hopper.cuh``: :func:`launch_plan` picks how many CTAs of
a cluster split the units of each 64-row tile, and the packed W_hh^T gate
slabs and their tensor map are built once per weight tensor
(:func:`layer_operands`). Its f32 route is K5's f32 recurrence
(``csrc/gru_fwd_hopper.cuh``, mode ``kLayer``): the product as six bf16
``wgmma`` passes over exact pieces, 64 units a CTA (:func:`f32_plan`), the
W_hh pieces and their map K5's (``gru_train_kernel.fwd_operands``).
``gru_layer_reference`` is its plain PyTorch version, op for op the JAX
kernel's (``_gru_stream_kernel``):

- the carry h is held in the parameter dtype and rounded to it after every
  step (:func:`carry`; K5's carry is f32);
- ``hw = h @ W_hh`` takes h in the parameter dtype, accumulates in f32, and
  adds ``b_hh`` in f32 (:func:`layer_product`);
- the gates run in f32 on ``xw`` and h upcast
  (``kernel_common.gru_gates_f32``);
- a step whose mask is 0 keeps h and emits the held h, so an all-zero row
  returns ``h0``;
- ``reverse`` runs t = T-1 .. 0; the outputs stay in time order.

In bf16 the JAX package's K9 and K10 do not trace (their gate math promotes
the carry to f32, which the kernels then store into a bf16 ref); K8 and
this port run in bf16 and f32.

:func:`agreement` holds a kernel's outputs against the plain version's: by
the max absolute error, and in bf16 also by the share of elements that are
not bit-equal (a carry kept in f32 moves a fifth or more of the elements by
an ulp; a legitimate rounding flip, from another summation order, moves
few).

Above 1024 units (the LatentRNN's generation GRU at ``--latent_rnn_hidden_size``
above 512) both dtypes run K5's recurrence in mode ``kLayer`` on tile
groups that span clusters (``kernel_common.tile_plan``, :func:`tile_plan_of`):
64 units a CTA in f32, 128 in bf16 (``kernel_common.tile_units``; the bf16
route's whole h tile no longer fits a CTA's shared memory), the CTAs of a
tile meeting at a counter in global memory, or one launch a step for a
group the card cannot hold at once. So K8 takes every width
(``kernel_common.gru_layer_width``): a layer whose width the plans do not
take (not whole 64-unit blocks; in bf16 above 512 an odd number of them,
above 1024 of 128-unit blocks) runs at the next width they do, on zero
units (:func:`padded_operands`), and is sliced back.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from inpaintnet_tpu_torch.ops.encoder_kernel import pack_gate_blocks
from inpaintnet_tpu_torch.ops.gru_train_kernel import fwd_operands, fwd_ring_stages, fwd_w_map
from inpaintnet_tpu_torch.ops.kernel_common import (
    DTYPE_CODES,
    HOPPER_ROWS,
    SYNC_CODES,
    LaunchPlan,
    WeightCache,
    card_tile_plan,
    check_cuda_tensor,
    check_launch,
    counts_launches,
    data_ptr,
    group_fault,
    gru_gates_f32,
    gru_layer_width,
    load_kernels,
    pad_units,
    padded_gru_layer,
    recurrence_plan,
    recurrence_slots,
    ring_stages,
    slab_map,
    stream_ptr,
    tile_scratch,
    tile_units,
    unpad_units,
)


def carry(h_new: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K8's carry from one step to the next: the f32 gate output rounded to
    the parameter dtype (the JAX kernel's ``h_scratch`` is that dtype)."""
    return h_new.to(dtype)


def layer_product(h: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """K8's recurrent product: the carry in the parameter dtype @ f32
    ``W_hh`` (one place, so a check can plant h taken as one bf16 piece)."""
    return h.float() @ w_hh


def gru_layer_reference(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                        h0: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                        reverse: bool = False, want_ys: bool = True):
    """Plain version of K8.

    :param xw: (B, T, 3H) = x @ W_ih + b_ih; w_hh: (H, 3H); b_hh: (3H,);
        h0: (B, H), all in the parameter dtype
    :param mask: optional (B, T); a step whose mask is 0 keeps h
    :param reverse: run t = T-1 .. 0 (outputs stay in time order)
    :param want_ys: False returns no outputs, only the final hidden
    :return: (outputs (B, T, H) or None, h_last (B, H)), parameter dtype
    """
    dtype = xw.dtype
    seq_len, hidden = xw.shape[1], w_hh.shape[0]
    whh, bhh = w_hh.float(), b_hh.float()
    keep = None if mask is None else (mask > 0)[..., None]
    h = h0
    ys = [None] * seq_len
    for t in (range(seq_len - 1, -1, -1) if reverse else range(seq_len)):
        hw = layer_product(h.to(dtype), whh) + bhh
        h_new = carry(gru_gates_f32(xw[:, t].float(), hw, h.float(), hidden), dtype)
        h = h_new if keep is None else torch.where(keep[:, t], h_new, h)
        ys[t] = h
    if not want_ys:
        return None, h.to(dtype)
    return torch.stack(ys, dim=1).to(dtype), h.to(dtype)


def held_pieces_fault_reference(xw, w_hh, b_hh, h0, mask, *, reverse: bool = False,
                                want_ys: bool = True):
    """The planted fault "a held row writes no pieces" of K8's f32 route, in
    plain PyTorch: the kernel's product reads its operand from the scratch
    buffer of the step's parity, which holds h0 before step 0 and what each
    row last wrote there; here a held row writes nothing, so a row that runs
    after a hold multiplies the h of two steps (or more) before, or zeros
    where its buffer was never written. The gates take the right carry.
    Arguments and results as :func:`gru_layer_reference` (f32)."""
    seq_len, hidden = xw.shape[1], w_hh.shape[0]
    keep = (mask > 0)[..., None]
    h, bufs = h0, [h0, torch.zeros_like(h0)]
    ys = [None] * seq_len
    order = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
    for s, t in enumerate(order):
        hw = layer_product(bufs[s & 1], w_hh) + b_hh
        h = torch.where(keep[:, t], gru_gates_f32(xw[:, t], hw, h, hidden), h)
        bufs[(s + 1) & 1] = torch.where(keep[:, t], h, bufs[(s + 1) & 1])
        ys[t] = h
    return (torch.stack(ys, dim=1) if want_ys else None), h


def launch_plan(rows: int, hidden: int, sms: int, slots=None) -> LaunchPlan:
    """How K8's bf16 route runs ``rows`` rows at ``hidden`` units on a card
    of ``sms`` SMs: the cluster size (CTAs sharing a 64-row tile, each
    computing ``hidden / cluster`` units) and the ring depth beside the one
    h tile (``kernel_common.recurrence_plan``; ``slots``: the clusters of
    each size the card runs at once)."""
    return recurrence_plan(rows, hidden, sms, h_tiles=1, slots=slots)


def card_plan(rows: int, hidden: int, device) -> LaunchPlan:
    """:func:`launch_plan` on the card ``device`` names, with its own SM
    count and cluster slots: the plan :func:`gru_layer_stream` launches."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    slots = recurrence_slots("inpaint_gru_layer_slots", hidden, ring_stages(hidden, 1), index)
    return launch_plan(rows, hidden, torch.cuda.get_device_properties(index).multi_processor_count,
                       slots)


F32_UNITS = 64  # units of a CTA of the f32 route (K5's f32 register budget)
F32_MAX_CLUSTER = 16  # H 1024: a non-portable cluster


def f32_plan(hidden: int) -> LaunchPlan:
    """How K8's f32 route runs ``hidden`` units, whatever the rows: H / 64
    CTAs a 64-row tile, each owning 64 units of all three gates (a consumer
    warpgroup's 32-unit chunk holds the sum and the slab's partial, 96
    registers), so H 1024 takes 16 (a non-portable cluster; 128 units a
    CTA would need 168 KB ring stages, and a ring holds two), and K5's ring
    depth for 64 units. Raises ValueError for a width no plan takes."""
    if hidden % F32_UNITS or not 0 < hidden <= F32_UNITS * F32_MAX_CLUSTER:
        raise ValueError(f"no f32 K8 plan for hidden size {hidden}")
    return LaunchPlan(hidden // F32_UNITS, fwd_ring_stages(F32_UNITS, 3))


def tile_plan_of(rows: int, hidden: int, dtype, device):
    """K8's tile-group plan on the card ``device`` names
    (``kernel_common.card_tile_plan``: K5's ring depth for the CTA's
    units), or None where the cluster routes run (up to 1024 units)."""
    units = tile_units(dtype)
    return card_tile_plan(rows, hidden, dtype, "K8", "inpaint_gru_layer_resident",
                          fwd_ring_stages(units, 3 if dtype == torch.float32 else 1), device)


def _build_layer_operands(w_hh: torch.Tensor):
    packed = pack_gate_blocks(w_hh)
    buf, addr = slab_map(packed)
    return packed, buf, addr


# (packed W_hh^T gate blocks, the map's buffer, its aligned address) per W_hh
layer_operands = WeightCache(_build_layer_operands)


def padded_operands(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                    h0: torch.Tensor, padded=None) -> tuple:
    """K8's operands at ``padded`` units, by default the width it runs
    ``hidden`` units at (``kernel_common.gru_layer_width``): (xw, W_hh,
    b_hh, h0) with zero units, gate by gate (``kernel_common.pad_units``;
    W_hh and b_hh cached per weight tensor, xw and h0 padded per call). The
    plain version on them, sliced back to ``hidden`` units, is the plain
    version at ``hidden``."""
    hidden = w_hh.shape[0]
    padded = padded or gru_layer_width(hidden, xw.dtype)
    w, b = padded_gru_layer(w_hh, b_hh, padded=padded)
    return pad_units(xw, hidden, padded, 3), w, b, pad_units(h0, hidden, padded)


@counts_launches  # proves a run went through K8
def gru_layer_stream(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                     h0: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                     reverse: bool = False, want_ys: bool = True):
    """K8: arguments and result as :func:`gru_layer_reference`."""
    if xw.device.type == "cpu":
        return gru_layer_reference(xw, w_hh, b_hh, h0, mask, reverse=reverse, want_ys=want_ys)
    dtype, device = xw.dtype, xw.device
    if device.type != "cuda":
        raise ValueError(f"gru_layer_stream: no kernel for device {device}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"gru_layer_stream: no kernel for dtype {dtype}")
    hidden = w_hh.shape[0]
    padded = gru_layer_width(hidden, dtype)
    if padded is None:
        raise ValueError(f"gru_layer_stream: no kernel for hidden size {hidden} in {dtype}")
    if padded != hidden:  # zero units up to a width the plans take
        ys, hn = gru_layer_stream(*padded_operands(xw, w_hh, b_hh, h0), mask, reverse=reverse,
                                  want_ys=want_ys)
        return (None if ys is None else unpad_units(ys, hidden, padded),
                unpad_units(hn, hidden, padded))
    batch, seq_len = xw.shape[:2]
    check_cuda_tensor("xw", xw, (batch, seq_len, 3 * hidden), dtype, device)
    check_cuda_tensor("w_hh", w_hh, (hidden, 3 * hidden), dtype, device)
    check_cuda_tensor("b_hh", b_hh, (3 * hidden,), dtype, device)
    check_cuda_tensor("h0", h0, (batch, hidden), dtype, device)
    keep = None
    if mask is not None:
        if tuple(mask.shape) != (batch, seq_len) or mask.device != device:
            raise ValueError(f"mask: {tuple(mask.shape)} on {mask.device}, expected "
                             f"{(batch, seq_len)} on {device}")
        keep = (mask > 0).to(torch.uint8).contiguous()
    ys = torch.empty((batch, seq_len, hidden), dtype=dtype, device=device) if want_ys else None
    hn = torch.empty((batch, hidden), dtype=dtype, device=device)
    ptrs = (xw.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
            None if keep is None else keep.data_ptr(), None if ys is None else ys.data_ptr(),
            hn.data_ptr())
    lib = load_kernels()
    tiles_plan = tile_plan_of(batch, hidden, dtype, device)
    if tiles_plan is not None:
        units, pieces = tile_units(dtype), 3 if dtype == torch.float32 else 1
        counters, carry = tile_scratch(tiles_plan, batch, hidden, device)
        scratch = torch.empty((-(-batch // HOPPER_ROWS), 2, pieces, HOPPER_ROWS, hidden),
                              dtype=torch.bfloat16, device=device)
        err = lib.inpaint_gru_layer_tiles(
            DTYPE_CODES[dtype], fwd_w_map(fwd_operands(w_hh), hidden, units), *ptrs,
            scratch.data_ptr(), data_ptr(counters), data_ptr(carry), batch, seq_len, hidden,
            int(reverse), tiles_plan.ctas, tiles_plan.groups, fwd_ring_stages(units, pieces),
            SYNC_CODES[tiles_plan.route], group_fault(), stream_ptr())
    elif dtype == torch.bfloat16:
        plan = card_plan(batch, hidden, device)
        _, _, map_addr = layer_operands(w_hh)
        err = lib.inpaint_gru_layer_bf16(map_addr, *ptrs, batch, seq_len, hidden, int(reverse),
                                         plan.cluster, plan.stages, stream_ptr())
    else:
        plan = f32_plan(hidden)
        map_addr = fwd_w_map(fwd_operands(w_hh), hidden, F32_UNITS)
        # the exchange of h's three pieces, by step parity
        scratch = torch.empty((-(-batch // HOPPER_ROWS), 2, 3, HOPPER_ROWS, hidden),
                              dtype=torch.bfloat16, device=device)
        err = lib.inpaint_gru_layer_f32(map_addr, *ptrs, scratch.data_ptr(), batch, seq_len,
                                        hidden, int(reverse), plan.cluster, plan.stages,
                                        stream_ptr())
    check_launch(err, "gru_layer_stream")
    gru_layer_stream.launches += 1
    return ys, hn


BF16_ULP_OF_H = 2.0 ** -8  # the bf16 ulp of |h| in [0.5, 1), the scale of a GRU state
# K8 against its plain version, by :func:`agreement`, on the card and on the
# CPU against the JAX kernel. f32: both sides accumulate in true f32, so only
# the summation order differs. bf16: both take exact products of bf16
# operands and sum them in f32; another order (another BLAS kernel, the
# card's mma) may flip the bf16 rounding of a carry by an ulp, and the row's
# later steps follow it. The bound allows 4 ulps of h's scale on 2% of the
# elements; a carry kept in f32 changes a fifth or more of them (at two
# steps or more: at one the carry cannot matter), a mask read one step late
# moves a held row by more than 1. PERF.md gives the readings.
BOUNDS = {torch.float32: {"max_abs_err": 1e-5},
          torch.bfloat16: {"max_abs_err": 4 * BF16_ULP_OF_H, "share_changed": 0.02}}


def agreement(got, want) -> dict:
    """(ys or None, h_n) of K8 against its plain version's: the max absolute
    error over both (a bf16 bound counts it in ``BF16_ULP_OF_H``: a flip
    cascades onto near-zero elements, whose own ulps would count it
    thousands of times); in bf16 also the share of elements that are not
    bit-equal."""
    pairs = [(g, w) for g, w in zip(got, want) if g is not None]
    out = {"max_abs_err": max((g.float() - w.float()).abs().max().item() for g, w in pairs)}
    if pairs[0][0].dtype == torch.bfloat16:
        changed = sum(int((g != w).sum().item()) for g, w in pairs)
        out["share_changed"] = changed / sum(g.numel() for g, _ in pairs)
    return out


def within(agree: dict, bound: dict) -> bool:
    """Every measure of :func:`agreement` that ``bound`` names is at or
    under its limit."""
    return all(agree[k] <= v for k, v in bound.items())
