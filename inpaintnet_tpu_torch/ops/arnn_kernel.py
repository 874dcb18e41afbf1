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
``arnn_decode_inputs``, as the TPU kernel's are. The wrapper runs the
plain version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from inpaintnet_tpu_torch.ops.kernel_common import (
    DTYPE_CODES,
    check_cuda_tensor,
    check_launch,
    kernel_supports_hidden,
    load_kernels,
    lstm_gates_f32,
    pack_mma_b,
    round_up,
    stream_ptr,
)

SMEM_LIMIT = 232_448  # bytes of shared memory one block may take on Hopper
_ROWS = {torch.float32: 16, torch.bfloat16: 32}  # rows of a block's tile
_PAD = {torch.float32: 4, torch.bfloat16: 8}  # smem row padding, elements


def _head_pads(linear: int, vocab: int):
    """(LP, VP): the head's hidden width padded to whole 16-deep products,
    the vocab to whole 8-column tiles (zero weights, so the padding adds
    nothing to the real columns)."""
    return round_up(linear, 16), round_up(vocab, 8)


def arnn_kernel_smem_bytes(hidden: int, ctx: int, linear: int, vocab: int, dtype) -> int:
    """K7's dynamic shared memory: four padded h tiles (both layers, current
    and next), two unpadded c tiles, and one region that holds the tick's
    context rows in layer 0 and the head's hidden tile and f32 logits after
    layer 1; plus the fed-back tokens. ``csrc/arnn_decode.cu`` computes the
    same."""
    rows, pad, size = _ROWS[dtype], _PAD[dtype], torch.finfo(dtype).bits // 8
    lp, vp = _head_pads(linear, vocab)
    shared = max(rows * (ctx + pad) * size, rows * (lp + pad) * size + rows * vp * 4)
    return (4 * rows * (hidden + pad) + 2 * rows * hidden) * size + shared + rows * 4


def arnn_kernel_supports(hidden: int, ctx: int, linear: int, vocab: int, dtype) -> bool:
    """Whether K7 takes this geometry: f32 or bf16, H and C whole 64-unit
    chunks up to 512 (``kernel_supports_hidden``), and a tile that fits one
    block's shared memory."""
    return (dtype in DTYPE_CODES and kernel_supports_hidden(hidden)
            and kernel_supports_hidden(ctx)
            and arnn_kernel_smem_bytes(hidden, ctx, linear, vocab, dtype) <= SMEM_LIMIT)


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


def carry_c(c: torch.Tensor, dtype) -> torch.Tensor:
    """The c carry as the next tick reads it: rounded to the parameter
    dtype (one place, so a check can plant a carry kept in f32)."""
    return c.to(dtype)


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
        xw0 = prev + ctx[:, t].float() @ f["w_ctx"] + f["bias"][0]
        hw0 = h0.float() @ f["whh0"] + f["bias"][1]
        h0, c0_new = lstm_gates_f32(xw0, hw0, c0.float(), hidden)
        h0, c0 = h0.to(dtype), carry_c(c0_new, dtype)
        xw1 = h0.float() @ f["wih1"] + f["bias"][2]
        hw1 = h1.float() @ f["whh1"] + f["bias"][3]
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


def arnn_sampled_decode(params, ctx: torch.Tensor, score: torch.Tensor,
                        force_mask: torch.Tensor, start_emb: torch.Tensor):
    """K7: the argmax decode with forced ticks over the whole sequence.

    Arguments and results as :func:`arnn_sampled_decode_reference`, with
    (in, out) weights in f32 or bf16, ``score`` and ``force_mask`` int32;
    the entries of ``score`` at forced ticks must lie in [0, n_tok)."""
    if ctx.device.type == "cpu":
        return arnn_sampled_decode_reference(params, ctx, score, force_mask, start_emb)
    if ctx.device.type != "cuda":
        raise ValueError(f"arnn_sampled_decode: no kernel for device {ctx.device}")
    if len(params["lstm_generation"]) != 2:
        raise ValueError("arnn_sampled_decode: takes a 2-layer generation LSTM")
    p0, p1 = params["lstm_generation"]
    device, dtype = ctx.device, p0["w_hh"].dtype
    batch, seq_len, C = ctx.shape
    hidden = p0["w_hh"].shape[0]
    linear, vocab = params["linear_output_notes"]["w"].shape
    if not arnn_kernel_supports(hidden, C, linear, vocab, dtype):
        raise ValueError(f"arnn_sampled_decode: no kernel for dtype {dtype}, hidden size "
                         f"{hidden}, context {C}, head {linear} x {vocab}")
    emb = params["note_embedding"]["table"]
    E = emb.shape[1]
    check_cuda_tensor("ctx", ctx, (batch, seq_len, C), dtype, device)
    for tag, t in (("score", score), ("force_mask", force_mask)):
        check_cuda_tensor(tag, t, (batch, seq_len), torch.int32, device)
    check_cuda_tensor("start_emb", start_emb, (1, E), dtype, device)
    check_cuda_tensor("lstm_generation0.w_ih", p0["w_ih"], (E + C, 4 * hidden), dtype, device)
    for tag, w in (("lstm_generation0.w_hh", p0["w_hh"]), ("lstm_generation1.w_ih", p1["w_ih"]),
                   ("lstm_generation1.w_hh", p1["w_hh"])):
        check_cuda_tensor(tag, w, (hidden, 4 * hidden), dtype, device)
    for tag, b in (("lstm_generation0.b_ih", p0["b_ih"]), ("lstm_generation0.b_hh", p0["b_hh"]),
                   ("lstm_generation1.b_ih", p1["b_ih"]), ("lstm_generation1.b_hh", p1["b_hh"])):
        check_cuda_tensor(tag, b, (4 * hidden,), dtype, device)
    check_cuda_tensor("linear_1.w", params["linear_1"]["w"], (hidden, linear), dtype, device)
    check_cuda_tensor("linear_1.b", params["linear_1"]["b"], (linear,), dtype, device)
    check_cuda_tensor("linear_output_notes.b", params["linear_output_notes"]["b"], (vocab,),
                      dtype, device)

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
    arnn_sampled_decode.launches += 1
    return logits, tokens


arnn_sampled_decode.launches = 0  # kernel launches, for proving a run went through K7


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
