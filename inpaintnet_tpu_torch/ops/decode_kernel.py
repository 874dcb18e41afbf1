"""K2: the hierarchical decoder's 24-tick argmax sampling decode.

``decode_sampling`` is the CUDA kernel ``csrc/decode_sampling.cu`` (it
replaces the TPU kernel ``inpaintnet_tpu/ops/decode_pallas.py
decode_sampling_pallas``; the source says what bounds it on the card and
how its design answers). ``decode_sampling_reference`` is its plain
PyTorch version with the same numerics: products accumulate in f32, biases
and gates in f32, both carries are rounded to the parameter dtype every
tick, the fed-back row is a row of the parameter-dtype token table, the
argmax runs on the f32 logits (first index among equal maxima), and the
logits are returned in the parameter dtype.

The products around the loop (token table, tick-0 input, beat-context
projection) are computed outside the kernel by ``decode_inputs``, as the
TPU kernel's are. The wrapper runs the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from inpaintnet_tpu_torch.ops.kernel_common import (
    DTYPE_CODES,
    check_cuda_tensor,
    check_launch,
    gru_gates_f32,
    kernel_supports_hidden,
    load_kernels,
    pack_mma_b,
    round_up,
    stream_ptr,
)

NUM_TICKS = 24
TICKS_PER_BEAT = 6


def decode_inputs(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor) -> dict:
    """The loop's precomputed operands, all in the parameter dtype:
    ``tok_tab`` (V, 3H) = emb @ W_ih0[:E]; ``x0_xw`` (3H,) = x_0 @ W_ih0[:E];
    ``ctx_xw`` (4, B, 3H) = tick_ctx @ W_ih0[E:] + b_ih0; ``hi0``/``hi1``
    (4, B, H) beat-major init hiddens."""
    p0 = params["tick_gru"][0][0]
    dtype = p0["w_hh"].dtype
    emb = params["embedding"]["table"]
    E = emb.shape[1]
    w_tok, w_ctx = p0["w_ih"][:E].float(), p0["w_ih"][E:].float()
    ctx_xw = (tick_ctx.float() @ w_ctx).to(dtype) + p0["b_ih"]
    return {
        "tok_tab": (emb.float() @ w_tok).to(dtype),
        "x0_xw": (params["x_0"].float() @ w_tok).to(dtype),
        "ctx_xw": ctx_xw.transpose(0, 1).contiguous(),
        "hi0": h_inits[0].transpose(0, 1).contiguous(),
        "hi1": h_inits[1].transpose(0, 1).contiguous(),
    }


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
        if t % TICKS_PER_BEAT == 0:
            h0, h1 = ins["hi0"][beat], ins["hi1"][beat]
        xw0 = prev + ins["ctx_xw"][beat].float()
        hw0 = h0.float() @ f["whh0"] + f["bhh0"]
        h0 = gru_gates_f32(xw0, hw0, h0.float(), hidden).to(dtype)
        xw1 = h0.float() @ f["wih1"] + f["bih1"]
        hw1 = h1.float() @ f["whh1"] + f["bhh1"]
        h1 = gru_gates_f32(xw1, hw1, h1.float(), hidden).to(dtype)
        lg = torch.relu(h1.float() @ f["head_w"] + f["head_b"])
        s = torch.argmax(lg, dim=-1)  # first index among equal maxima
        prev = ins["tok_tab"][s].float()
        logits.append(lg.to(dtype))
        samples.append(s)
    return torch.stack(logits, dim=1), torch.stack(samples, dim=1).to(torch.int32)


def decode_sampling(params, tick_ctx: torch.Tensor, h_inits: torch.Tensor):
    """K2: argmax decode of one measure per row.

    :param params: HierarchicalDecoder params, (in, out) weights, f32 or bf16
    :param tick_ctx: (B, 4, H) per-beat context (selu'd beat_to_tick_input)
    :param h_inits: (2, B, 4, H) per-beat tick-GRU init hiddens
    :return: (logits (B, 24, V) in the parameter dtype, samples (B, 24) int32)
    """
    if tick_ctx.device.type == "cpu":
        return decode_sampling_reference(params, tick_ctx, h_inits)
    if tick_ctx.device.type != "cuda":
        raise ValueError(f"decode_sampling: no kernel for device {tick_ctx.device}")
    if len(params["tick_gru"]) != 2:
        raise ValueError("decode_sampling: takes a 2-layer tick GRU")
    p0, p1 = params["tick_gru"][0][0], params["tick_gru"][1][0]
    device, dtype = tick_ctx.device, p0["w_hh"].dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"decode_sampling: no kernel for dtype {dtype}")
    batch, num_beats, hidden = tick_ctx.shape
    if num_beats != NUM_TICKS // TICKS_PER_BEAT or not kernel_supports_hidden(hidden):
        raise ValueError(f"decode_sampling: no kernel for (beats, hidden) "
                         f"{(num_beats, hidden)}")
    check_cuda_tensor("tick_ctx", tick_ctx, (batch, num_beats, hidden), dtype, device)
    check_cuda_tensor("h_inits", h_inits, (2, batch, num_beats, hidden), dtype, device)
    for name, w in (("tick_gru0.w_hh", p0["w_hh"]), ("tick_gru1.w_ih", p1["w_ih"]),
                    ("tick_gru1.w_hh", p1["w_hh"])):
        check_cuda_tensor(name, w, (hidden, 3 * hidden), dtype, device)
    for name, b in (("tick_gru0.b_hh", p0["b_hh"]), ("tick_gru1.b_ih", p1["b_ih"]),
                    ("tick_gru1.b_hh", p1["b_hh"])):
        check_cuda_tensor(name, b, (3 * hidden,), dtype, device)
    vocab = params["head"]["w"].shape[1]
    check_cuda_tensor("head.w", params["head"]["w"], (hidden, vocab), dtype, device)
    check_cuda_tensor("head.b", params["head"]["b"], (vocab,), dtype, device)

    ins = decode_inputs(params, tick_ctx, h_inits)
    vocab_pad = round_up(vocab, 8)
    head_w = torch.nn.functional.pad(params["head"]["w"], (0, vocab_pad - vocab))
    head_b = torch.nn.functional.pad(params["head"]["b"], (0, vocab_pad - vocab))
    whh0, wih1, whh1, head_w = (pack_mma_b(w) for w in (p0["w_hh"], p1["w_ih"],
                                                         p1["w_hh"], head_w))
    bias = torch.stack([p0["b_hh"], p1["b_ih"], p1["b_hh"]])
    logits = torch.empty((batch, NUM_TICKS, vocab), dtype=dtype, device=device)
    samples = torch.empty((batch, NUM_TICKS), dtype=torch.int32, device=device)

    err = load_kernels().inpaint_decode_sampling(
        DTYPE_CODES[dtype], ins["ctx_xw"].data_ptr(), ins["hi0"].data_ptr(),
        ins["hi1"].data_ptr(), ins["tok_tab"].data_ptr(), ins["x0_xw"].data_ptr(),
        whh0.data_ptr(), wih1.data_ptr(),
        whh1.data_ptr(), bias.data_ptr(), head_w.data_ptr(), head_b.data_ptr(),
        logits.data_ptr(), samples.data_ptr(), batch, hidden, vocab, vocab_pad,
        stream_ptr())
    check_launch(err, "decode_sampling")
    decode_sampling.launches += 1
    return logits, samples


decode_sampling.launches = 0  # kernel launches, for proving a run went through K2
