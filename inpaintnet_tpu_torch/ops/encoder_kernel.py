"""K1: final hiddens of the 2-layer bidirectional encoder GRU from tokens.

``encoder_hn`` is the CUDA kernel ``csrc/encoder_gru.cu`` (it replaces the
TPU kernel ``inpaintnet_tpu/ops/encoder_pallas.py encoder_hn_pallas``; the
source says what bounds it on the card and how its design answers).
``encoder_hn_reference`` is its plain PyTorch version with the same
numerics: products accumulate in f32, biases and gates in f32, and the
carry and the layer-0 outputs are rounded to the parameter dtype after
every step. For f32 parameters that is exactly the XLA scan
``gru_apply(..., last_outputs=False)[1]``.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
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
    stream_ptr,
)


def fused_tables(gru_params, emb_table: torch.Tensor):
    """Layer 0's embedding-then-input-projection as one (V, 3H) table per
    direction, ``emb @ W_ih`` in f32 rounded once to the parameter dtype
    (computed outside the kernel, as the TPU kernel's tables are)."""
    dtype = gru_params[0][0]["w_hh"].dtype
    return [(emb_table.float() @ p["w_ih"].float()).to(dtype) for p in gru_params[0]]


def encoder_hn_reference(gru_params, emb_table: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """Plain version of K1. :return: h_n (4, B, H) [l0f, l0b, l1f, l1b] in
    the parameter dtype."""
    dtype = gru_params[0][0]["w_hh"].dtype
    hidden = gru_params[0][0]["w_hh"].shape[0]
    batch, seq_len = tokens.shape
    tokens = tokens.long()

    def run(p, xw_at, reverse):
        h = tokens.new_zeros((batch, hidden), dtype=dtype)
        whh, bhh = p["w_hh"].float(), p["b_hh"].float()
        ys = [None] * seq_len
        for t in (range(seq_len - 1, -1, -1) if reverse else range(seq_len)):
            hw = h.float() @ whh + bhh
            h = gru_gates_f32(xw_at(t), hw, h.float(), hidden).to(dtype)
            ys[t] = h
        return ys, h

    h_n, ys0 = [], []
    for d, (p, tab) in enumerate(zip(gru_params[0], fused_tables(gru_params, emb_table))):
        bih = p["b_ih"].float()
        ys, h = run(p, lambda t, tab=tab, bih=bih: tab[tokens[:, t]].float() + bih, d == 1)
        ys0.append(ys)
        h_n.append(h)
    for d, p in enumerate(gru_params[1]):
        wih, bih = p["w_ih"].float(), p["b_ih"].float()
        _, h = run(p, lambda t, wih=wih, bih=bih:
                   torch.cat([ys0[0][t], ys0[1][t]], dim=-1).float() @ wih + bih, d == 1)
        h_n.append(h)
    return torch.stack(h_n, dim=0)


def encoder_hn(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """K1: h_n (4, B, H) of the 2-layer bidirectional GRU over
    ``emb_table[tokens]``.

    :param gru_params: ``[layer][direction]`` dicts, (in, 3H) weights, f32 or bf16
    :param emb_table: (V, E) in the parameter dtype
    :param tokens: (B, T) int32 in [0, V)
    """
    if tokens.device.type == "cpu":
        return encoder_hn_reference(gru_params, emb_table, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"encoder_hn: no kernel for device {tokens.device}")
    if len(gru_params) != 2 or len(gru_params[0]) != 2:
        raise ValueError("encoder_hn: takes a 2-layer bidirectional GRU")
    p0f, p0b = gru_params[0]
    p1f, p1b = gru_params[1]
    device, dtype = tokens.device, p0f["w_hh"].dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"encoder_hn: no kernel for dtype {dtype}")
    hidden = p0f["w_hh"].shape[0]
    if not kernel_supports_hidden(hidden):
        raise ValueError(f"encoder_hn: no kernel for hidden size {hidden}")
    batch, seq_len = tokens.shape
    vocab, emb_dim = emb_table.shape
    check_cuda_tensor("tokens", tokens, (batch, seq_len), torch.int32, device)
    check_cuda_tensor("emb_table", emb_table, (vocab, emb_dim), dtype, device)
    for name, p, in_dim in (("l0f", p0f, emb_dim), ("l0b", p0b, emb_dim),
                            ("l1f", p1f, 2 * hidden), ("l1b", p1b, 2 * hidden)):
        check_cuda_tensor(f"{name}.w_ih", p["w_ih"], (in_dim, 3 * hidden), dtype, device)
        check_cuda_tensor(f"{name}.w_hh", p["w_hh"], (hidden, 3 * hidden), dtype, device)
        check_cuda_tensor(f"{name}.b_ih", p["b_ih"], (3 * hidden,), dtype, device)
        check_cuda_tensor(f"{name}.b_hh", p["b_hh"], (3 * hidden,), dtype, device)

    tab_f, tab_b = (t.contiguous() for t in fused_tables(gru_params, emb_table))
    whh0_f, whh0_b, wih1_f, wih1_b, whh1_f, whh1_b = (
        pack_mma_b(w) for w in (p0f["w_hh"], p0b["w_hh"], p1f["w_ih"], p1b["w_ih"],
                                p1f["w_hh"], p1b["w_hh"]))
    bih0 = torch.stack([p0f["b_ih"], p0b["b_ih"]])
    bhh0 = torch.stack([p0f["b_hh"], p0b["b_hh"]])
    bih1 = torch.stack([p1f["b_ih"], p1b["b_ih"]])
    bhh1 = torch.stack([p1f["b_hh"], p1b["b_hh"]])
    ys = torch.empty((2, seq_len, batch, hidden), dtype=dtype, device=device)
    h_n = torch.empty((4, batch, hidden), dtype=dtype, device=device)

    err = load_kernels().inpaint_encoder_hn(
        DTYPE_CODES[dtype], tokens.data_ptr(), tab_f.data_ptr(), tab_b.data_ptr(),
        whh0_f.data_ptr(), whh0_b.data_ptr(), wih1_f.data_ptr(), wih1_b.data_ptr(),
        whh1_f.data_ptr(), whh1_b.data_ptr(), bih0.data_ptr(), bhh0.data_ptr(),
        bih1.data_ptr(), bhh1.data_ptr(), ys.data_ptr(), h_n.data_ptr(),
        batch, seq_len, hidden, vocab, stream_ptr())
    check_launch(err, "encoder_hn")
    encoder_hn.launches += 1
    return h_n


encoder_hn.launches = 0  # kernel launches, for proving a run went through K1
