"""K5 and K6: the forward and the sequential backward of one GRU layer
direction in training.

``gru_fwd_seq`` (K5) is the CUDA kernel ``csrc/gru_fwd_seq.cu`` and
``gru_bwd_seq`` (K6) is ``csrc/gru_bwd_seq.cu``; they replace the TPU kernels
``inpaintnet_tpu/ops/gru_bwd_pallas.py gru_fwd_seq_pallas`` and
``gru_bwd_seq_pallas`` (each source says what bounds it on the card and how
its design answers). ``gru_fwd_seq_reference`` and ``gru_bwd_seq_reference``
are their plain PyTorch versions, op for op the JAX kernels':

- K5: an f32 carry; the recurrent product on h rounded to the parameter
  dtype, accumulated in f32; ``hn = h @ W_hh + b_hh`` with its bias; the
  five outputs (ys, r, z, n, hn) stored in the parameter dtype.
- K6: the gate-derivative chain in f32; the product ``dhw @ W_hh^T`` on the
  UNROUNDED f32 dhw with W_hh upcast, accumulated in f32, in every dtype;
  da, dhw and dh0 stored in the parameter dtype.

``fwd_carry`` and ``bwd_product`` hold the two steps a kernel is most
likely to get wrong (the carry's precision, the product's operand
precision), so a check can plant a fault in the plain versions and show
that its bound rejects it.

The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from inpaintnet_tpu_torch.ops.kernel_common import (
    DTYPE_CODES,
    check_cuda_tensor,
    check_launch,
    kernel_supports_hidden,
    load_kernels,
    pack_mma_b,
    stream_ptr,
)


def fwd_carry(h_new: torch.Tensor) -> torch.Tensor:
    """K5's carry from one step to the next: the f32 state as it is."""
    return h_new


def bwd_product(dhw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """K6's recurrent product: f32 ``dhw`` (B, 3H) @ f32 ``W_hh^T`` (3H, H)."""
    return dhw @ w_hh_t


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
        hw = h.to(dtype).float() @ whh + bhh
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
        dh = g * zt + bwd_product(dhw, w_t)
        da_out[t] = torch.cat([dar, daz, dan], dim=-1).to(dtype)
        dhw_out[t] = dhw.to(dtype)
    return torch.stack(da_out), torch.stack(dhw_out), dh.to(dtype)


def _check_common(name: str, w_hh: torch.Tensor, device: torch.device, dtype: torch.dtype) -> int:
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {dtype}")
    hidden = w_hh.shape[0]
    if not kernel_supports_hidden(hidden):
        raise ValueError(f"{name}: no kernel for hidden size {hidden}")
    check_cuda_tensor("w_hh", w_hh, (hidden, 3 * hidden), dtype, device)
    return hidden


def gru_fwd_seq(w_hh: torch.Tensor, b_hh: torch.Tensor, xw: torch.Tensor, h0: torch.Tensor,
                *, reverse: bool = False):
    """K5: arguments and result as :func:`gru_fwd_seq_reference`."""
    if xw.device.type == "cpu":
        return gru_fwd_seq_reference(w_hh, b_hh, xw, h0, reverse=reverse)
    dtype, device = xw.dtype, xw.device
    hidden = _check_common("gru_fwd_seq", w_hh, device, dtype)
    batch, seq_len = xw.shape[:2]
    check_cuda_tensor("xw", xw, (batch, seq_len, 3 * hidden), dtype, device)
    check_cuda_tensor("b_hh", b_hh, (3 * hidden,), dtype, device)
    check_cuda_tensor("h0", h0, (batch, hidden), dtype, device)
    whh = pack_mma_b(w_hh)
    out = torch.empty((5, seq_len, batch, hidden), dtype=dtype, device=device)
    err = load_kernels().inpaint_gru_fwd_seq(
        DTYPE_CODES[dtype], xw.data_ptr(), whh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
        out.data_ptr(), batch, seq_len, hidden, int(reverse), stream_ptr())
    check_launch(err, "gru_fwd_seq")
    gru_fwd_seq.launches += 1
    return tuple(out.unbind(0))


gru_fwd_seq.launches = 0  # kernel launches, for proving a run went through K5


def gru_bwd_seq(w_hh: torch.Tensor, dys: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
                n: torch.Tensor, hn: torch.Tensor, hprev: torch.Tensor, *,
                reverse: bool = False):
    """K6: arguments and result as :func:`gru_bwd_seq_reference`."""
    if dys.device.type == "cpu":
        return gru_bwd_seq_reference(w_hh, dys, r, z, n, hn, hprev, reverse=reverse)
    dtype, device = dys.dtype, dys.device
    hidden = _check_common("gru_bwd_seq", w_hh, device, dtype)
    seq_len, batch = dys.shape[:2]
    for name, t in (("dys", dys), ("r", r), ("z", z), ("n", n), ("hn", hn), ("hprev", hprev)):
        check_cuda_tensor(name, t, (seq_len, batch, hidden), dtype, device)
    w_t = w_hh.float().t().contiguous()
    da = torch.empty((seq_len, batch, 3 * hidden), dtype=dtype, device=device)
    dhw = torch.empty_like(da)
    dh0 = torch.empty((batch, hidden), dtype=dtype, device=device)
    err = load_kernels().inpaint_gru_bwd_seq(
        DTYPE_CODES[dtype], dys.data_ptr(), r.data_ptr(), z.data_ptr(), n.data_ptr(),
        hn.data_ptr(), hprev.data_ptr(), w_t.data_ptr(), da.data_ptr(), dhw.data_ptr(),
        dh0.data_ptr(), batch, seq_len, hidden, int(reverse), stream_ptr())
    check_launch(err, "gru_bwd_seq")
    gru_bwd_seq.launches += 1
    return da, dhw, dh0


gru_bwd_seq.launches = 0  # kernel launches, for proving a run went through K6
