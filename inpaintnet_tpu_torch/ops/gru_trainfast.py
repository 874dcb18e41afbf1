"""The training GRU layer: a minimal-residual ``torch.autograd.Function``
(``inpaintnet_tpu/ops/gru_trainfast.py``).

The forward stores exactly what the backward needs, the post-activation
gates ``(r, z, n)`` and the recurrent candidate ``hn`` beside the outputs,
instead of autograd's per-step graph of the eager loop, and the backward is
written by hand:

- forward: ``xw = x @ W_ih + b_ih`` as one matrix product over all steps,
  then the recurrence, K5 (``ops/gru_train_kernel.gru_fwd_seq``);
- backward: the sequential ``dh`` recurrence, K6 (``gru_bwd_seq``), then
  every weight and input gradient as one batched product over the
  flattened (T * B) axis: ``dW_ih = X^T dA``, ``dW_hh = Hprev^T dHW``, the
  bias sums, ``dx = dA W_ih^T``.

A layer of a width the kernels' plans do not take runs at
``gru_train_kernel.trainfast_width`` on zero units, padded once: W_hh,
b_hh, xw and h0 on entry (``fwd_padded_operands``), the residuals saved at
that width for K6, ``dys`` padded once in the backward, and only the
outputs and gradients sliced back. Exact: a padded unit's dy is 0, so its
da, dhw and dh stay 0.

On the CPU the wrappers run their plain versions, so the Function computes
the JAX package's trainfast VJP with its Pallas kernels' numerics there too.

``h_last`` is a slice of ``ys`` taken outside the Function: autograd then
adds its cotangent into ``dys`` at the last processed step, which a second
output of the Function would not carry into K6's recurrence.
"""
from __future__ import annotations

import torch

from inpaintnet_tpu_torch.ops.gru_train_kernel import (
    fwd_padded_operands,
    gru_bwd_seq,
    gru_fwd_seq,
)
from inpaintnet_tpu_torch.ops.kernel_common import pad_units, unpad_units


class _GRULayerCore(torch.autograd.Function):
    """ys (B, T, H) of one GRU direction from (w_ih, w_hh, b_ih, b_hh, x, h0)."""

    @staticmethod
    def forward(ctx, reverse: bool, w_ih, w_hh, b_ih, b_hh, x, h0):
        xw = torch.matmul(x, w_ih) + b_ih
        w_p, b_p, xw_p, h0_p = fwd_padded_operands(w_hh, b_hh, xw, h0.contiguous())
        ys, r, z, n, hn = gru_fwd_seq(w_p, b_p, xw_p, h0_p, reverse=reverse)
        ctx.reverse, ctx.hidden = reverse, w_hh.shape[0]
        ctx.save_for_backward(w_ih, w_p, x, h0_p, ys, r, z, n, hn)
        return unpad_units(ys, ctx.hidden, ys.shape[2]).transpose(0, 1)

    @staticmethod
    def backward(ctx, dys):
        w_ih, w_p, x, h0_p, ys, r, z, n, hn = ctx.saved_tensors
        seq_len, batch, padded = ys.shape
        hidden = ctx.hidden
        # h_{t-1} of every step in original time order: the previous output
        # in processing order, h0 at the first processed step
        if ctx.reverse:
            hprev = torch.cat([ys[1:], h0_p[None]], dim=0)
        else:
            hprev = torch.cat([h0_p[None], ys[:-1]], dim=0)
        dys_t = pad_units(dys.transpose(0, 1).to(ys.dtype), hidden, padded).contiguous()
        da, dhw, dh0 = gru_bwd_seq(w_p, dys_t, r, z, n, hn, hprev, reverse=ctx.reverse)
        da, dhw = (unpad_units(t, hidden, padded, 3) for t in (da, dhw))
        hprev = unpad_units(hprev, hidden, padded)
        da_f = da.reshape(seq_len * batch, 3 * hidden)
        dhw_f = dhw.reshape(seq_len * batch, 3 * hidden)
        x_f = x.transpose(0, 1).reshape(seq_len * batch, -1)
        dw_ih = torch.matmul(x_f.t(), da_f)
        dw_hh = torch.matmul(hprev.reshape(seq_len * batch, hidden).t(), dhw_f)
        dx = torch.matmul(da.transpose(0, 1), w_ih.t())
        return (None, dw_ih, dw_hh, da_f.sum(0), dhw_f.sum(0), dx,
                unpad_units(dh0, hidden, padded))


def gru_layer_trainfast(params, x: torch.Tensor, h0: torch.Tensor, *, reverse: bool = False):
    """Single-direction GRU layer for training: ``(ys (B, T, H), h_last
    (B, H))``, outputs in original time order, the contract of
    ``ops.gru.gru_layer_apply`` without a mask."""
    ys = _GRULayerCore.apply(bool(reverse), params["w_ih"], params["w_hh"], params["b_ih"],
                             params["b_hh"], x, h0)
    return ys, (ys[:, 0] if reverse else ys[:, -1])
