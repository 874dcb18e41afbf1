"""LSTM recurrences of the AnticipationRNN family as eager PyTorch loops
(``inpaintnet_tpu/ops/lstm.py``).

Same parameter layout as the JAX package, per stack:
    [layer] -> {"w_ih": (in, 4H), "w_hh": (H, 4H), "b_ih": (4H,), "b_hh": (4H,)}
with torch's [i, f, g, o] gate order.

Masks: a step whose mask is 0 HOLDS (h, c) and emits the held h, so a
sequence padded at its end gives, at its valid steps, exactly the state
trajectory of its unpadded run once the reversed scan has crossed the
padding (the serving engine's mixed-length coalescing). cuDNN's packed
sequences emit zeros at pad steps and do not hold the state, so this is a
loop, not ``nn.LSTM``.

Training applies inverted dropout between the layers of a stack
(:func:`lstm_stack_apply`), with keep masks drawn from a
``torch.Generator`` or given by the caller.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from inpaintnet_tpu_torch.ops.gru import apply_dropout, dropout_keep
from inpaintnet_tpu_torch.ops.linear import xavier_normal


def lstm_cell_init(rng: np.random.Generator, input_size: int, hidden_size: int) -> dict:
    return {
        "w_ih": xavier_normal(rng, (input_size, 4 * hidden_size)),
        "w_hh": xavier_normal(rng, (hidden_size, 4 * hidden_size)),
        "b_ih": np.zeros((4 * hidden_size,), np.float32),
        "b_hh": np.zeros((4 * hidden_size,), np.float32),
    }


def lstm_stack_init(rng: np.random.Generator, sizes) -> list:
    """:param sizes: (input_size, hidden_size) per layer, as numpy."""
    return [lstm_cell_init(rng, i, h) for i, h in sizes]


def lstm_gates(params, h: torch.Tensor, c: torch.Tensor, xw: torch.Tensor):
    """One step's gate math given ``xw = x @ W_ih + b_ih``, in the tensors'
    own dtype (the JAX package's XLA scan does the same). -> (h, c)"""
    hidden = h.shape[-1]
    gates = xw + (h @ params["w_hh"] + params["b_hh"])
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden : 2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden : 3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden :])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_cell_apply(params, hc, x: torch.Tensor):
    """One LSTM step. hc: ((B, H), (B, H)), x: (B, in). -> (h, c)"""
    h, c = hc
    return lstm_gates(params, h, c, x @ params["w_ih"] + params["b_ih"])


def lstm_layer_apply(params, x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, *,
                     reverse: bool = False, mask: Optional[torch.Tensor] = None):
    """Single LSTM layer over a sequence.

    :param x: (B, T, in); h0, c0: (B, H)
    :param reverse: run t = T-1 .. 0 (outputs stay in original order)
    :param mask: optional (B, T) validity mask; masked steps hold (h, c)
        and emit the held h
    :return: (outputs (B, T, H), (h_last, c_last))
    """
    seq_len = x.shape[1]
    xw = x @ params["w_ih"] + params["b_ih"]  # one product for all T
    keep = None if mask is None else (mask > 0)[..., None]
    h, c = h0, c0
    ys = [None] * seq_len
    for t in (range(seq_len - 1, -1, -1) if reverse else range(seq_len)):
        h_new, c_new = lstm_gates(params, h, c, xw[:, t])
        if keep is None:
            h, c = h_new, c_new
        else:
            h = torch.where(keep[:, t], h_new, h)
            c = torch.where(keep[:, t], c_new, c)
        ys[t] = h
    return torch.stack(ys, dim=1), (h, c)


def lstm_stack_apply(params, x: torch.Tensor, hidden=None, *,
                     mask: Optional[torch.Tensor] = None, train: bool = False,
                     dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                     dropout_masks: Optional[Sequence[torch.Tensor]] = None):
    """A stack of LSTM layers over a sequence. In training, every layer's
    output but the last goes through inverted dropout: kept with probability
    ``1 - dropout``, scaled by ``1 / (1 - dropout)``.

    :param hidden: ((L, B, H), (L, B, H)) or None for zeros
    :param mask: optional (B, T) validity mask threaded to every layer
    :param dropout_masks: optional bool keep masks, (B, T, H), one per
        non-last layer, used instead of drawing from ``generator``
    :return: (outputs (B, T, H), (h_n (L, B, H), c_n (L, B, H)), the list of
        per-layer outputs, after their dropout)
    """
    num_layers = len(params)
    hid = params[0]["w_hh"].shape[0]
    if hidden is None:
        zeros = x.new_zeros((num_layers, x.shape[0], hid))
        hidden = (zeros, zeros)
    h0, c0 = hidden
    out = x
    h_n, c_n, all_hs = [], [], []
    for layer in range(num_layers):
        out, (h_last, c_last) = lstm_layer_apply(params[layer], out, h0[layer], c0[layer],
                                                 mask=mask)
        if train and dropout > 0.0 and layer < num_layers - 1:
            keep = (dropout_masks[layer] if dropout_masks is not None
                    else dropout_keep(out.shape, dropout, generator, out.device))
            out = apply_dropout(out, keep, dropout)
        h_n.append(h_last)
        c_n.append(c_last)
        all_hs.append(out)
    return out, (torch.stack(h_n), torch.stack(c_n)), all_hs
