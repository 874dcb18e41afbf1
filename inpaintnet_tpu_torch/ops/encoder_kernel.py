"""K1 and K3: final hiddens of the 2-layer bidirectional encoder GRU from
tokens.

``encoder_hn`` (K1) is the CUDA kernel ``csrc/encoder_gru.cu`` (it replaces
the TPU kernel ``inpaintnet_tpu/ops/encoder_pallas.py encoder_hn_pallas``;
the source says what bounds it on the card and how its design answers).
``encoder_hn_reference`` is its plain PyTorch version with the same
numerics: products accumulate in f32, biases and gates in f32, and the
carry and the layer-0 outputs are rounded to the parameter dtype after
every step. For f32 parameters that is exactly the XLA scan
``gru_apply(..., last_outputs=False)[1]``.

``encoder_hn_int8`` (K3, ``csrc/encoder_gru_int8.cu``) is the int8 serving
twin (``encoder_hn_pallas_int8``), with ``encoder_hn_int8_reference`` as
its plain version.

The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch the kernel or raise.
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
    pack_mma_b_s8,
    stream_ptr,
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


def _check_encoder_args(name: str, gru_params, emb_table: torch.Tensor, tokens: torch.Tensor):
    """The K1/K3 wrappers' checks of what the kernels take. -> (hidden,
    parameter dtype, device); raises ValueError otherwise."""
    if len(gru_params) != 2 or len(gru_params[0]) != 2 or len(gru_params[1]) != 2:
        raise ValueError(f"{name}: takes a 2-layer bidirectional GRU")
    (p0f, p0b), (p1f, p1b) = gru_params
    device, dtype = tokens.device, p0f["w_hh"].dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {dtype}")
    hidden = p0f["w_hh"].shape[0]
    if not kernel_supports_hidden(hidden):
        raise ValueError(f"{name}: no kernel for hidden size {hidden}")
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
    hidden, dtype, device = _check_encoder_args("encoder_hn", gru_params, emb_table, tokens)
    (p0f, p0b), (p1f, p1b) = gru_params
    batch, seq_len = tokens.shape
    vocab = emb_table.shape[0]

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


def encoder_int8_layers_reference(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor):
    """:func:`encoder_hn_int8_reference` with its int8 layer-0 slab.

    :return: (h_n (4, B, H), ys (2, T, B, H) int8 [forward, backward])
    """
    dtype = gru_params[0][0]["w_hh"].dtype
    hidden = gru_params[0][0]["w_hh"].shape[0]
    batch, seq_len = tokens.shape
    tokens = tokens.long()
    ops = encoder_int8_operands(gru_params, emb_table)

    def run(d, whh_q, s_h, bhh, xw_at):
        h_q = tokens.new_zeros((batch, hidden), dtype=torch.int8)
        whh = whh_q.float()
        ys = [None] * seq_len
        h_new = None
        for t in (range(seq_len - 1, -1, -1) if d == 1 else range(seq_len)):
            hw = (h_q.float() @ whh) * s_h + bhh
            h_new = gru_gates_f32(xw_at(t), hw, dequantize_h(h_q), hidden)
            h_q = quantize_h_int8(h_new)
            ys[t] = h_q
        return ys, h_new.to(dtype)

    h_n, ys0 = [], []
    for d in range(2):
        tab_q = ops["tab_q"][d]
        s_x, bih = ops["s_x0"][d], ops["bih0"][d]
        ys, h = run(d, ops["whh0_q"][d], ops["s_h0"][d], ops["bhh0"][d],
                    lambda t: tab_q[tokens[:, t]].float() * s_x + bih)
        ys0.append(ys)
        h_n.append(h)
    for d in range(2):
        wih = ops["wih1_q"][d].float()
        s_x, bih = ops["s_x1"][d], ops["bih1"][d]
        _, h = run(d, ops["whh1_q"][d], ops["s_h1"][d], ops["bhh1"][d],
                   lambda t: (torch.cat([ys0[0][t], ys0[1][t]], dim=-1).float() @ wih)
                   * s_x + bih)
        h_n.append(h)
    return torch.stack(h_n, dim=0), torch.stack([torch.stack(ys) for ys in ys0])


def encoder_hn_int8(gru_params, emb_table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """K3: ``encoder_hn`` with int8 products (``csrc/encoder_gru_int8.cu``;
    it replaces ``inpaintnet_tpu/ops/encoder_pallas.py
    encoder_hn_pallas_int8``). Same arguments and result as
    :func:`encoder_hn`; the numerics are :func:`encoder_hn_int8_reference`'s."""
    if tokens.device.type == "cpu":
        return encoder_hn_int8_reference(gru_params, emb_table, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"encoder_hn_int8: no kernel for device {tokens.device}")
    hidden, dtype, device = _check_encoder_args("encoder_hn_int8", gru_params, emb_table,
                                                tokens)
    batch, seq_len = tokens.shape
    vocab = emb_table.shape[0]
    ops = encoder_int8_operands(gru_params, emb_table)
    tab = ops["tab_q"]
    whh0, wih1, whh1 = (torch.stack([pack_mma_b_s8(w) for w in ops[k]])
                        for k in ("whh0_q", "wih1_q", "whh1_q"))
    f32 = {k: ops[k].contiguous() for k in ("s_x0", "s_h0", "s_x1", "s_h1",
                                            "bih0", "bhh0", "bih1", "bhh1")}
    ys = torch.empty((2, seq_len, batch, hidden), dtype=torch.int8, device=device)
    h_n = torch.empty((4, batch, hidden), dtype=dtype, device=device)

    err = load_kernels().inpaint_encoder_hn_int8(
        DTYPE_CODES[dtype], tokens.data_ptr(), tab.data_ptr(), whh0.data_ptr(),
        wih1.data_ptr(), whh1.data_ptr(), f32["s_x0"].data_ptr(), f32["s_h0"].data_ptr(),
        f32["s_x1"].data_ptr(), f32["s_h1"].data_ptr(), f32["bih0"].data_ptr(),
        f32["bhh0"].data_ptr(), f32["bih1"].data_ptr(), f32["bhh1"].data_ptr(),
        ys.data_ptr(), h_n.data_ptr(), batch, seq_len, hidden, vocab, stream_ptr())
    check_launch(err, "encoder_hn_int8")
    encoder_hn_int8.launches += 1
    return h_n


encoder_hn_int8.launches = 0  # kernel launches, for proving a run went through K3
