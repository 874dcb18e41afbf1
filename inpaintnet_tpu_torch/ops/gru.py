"""GRU recurrences (``inpaintnet_tpu/ops/gru.py``).

Same parameter layout as the JAX package, per stack:
    [layer][direction] -> {"w_ih": (in, 3H), "w_hh": (H, 3H),
                           "b_ih": (3H,),    "b_hh": (3H,)}
with torch's [r, z, n] gate order, and ``h_n`` in torch layout
``(num_layers * num_dirs, B, H)``, directions fastest.

Masks: a step whose mask is 0 keeps h and emits the held h, so a padded
sequence ends on the hidden of its last valid step, and an all-zero mask
(the serving engine's "no future context") leaves ``h0``. cuDNN's packed
sequences cannot express either (they emit zeros at pad steps and take no
all-empty sequence), so no route here is ``nn.GRU``.

The inference route of a layer, under the JAX package's names, so one
``INPAINTNET_GRU_IMPL`` picks the same route in both packages (read once,
at import; ``set_gru_impl``, ``gru_impl_scope`` or ``impl=`` override it):
- ``"xla"`` (the default): an eager loop, the gates in the tensors' own
  dtype (the JAX package's XLA scan);
- ``"pallas"``: ``xw = x @ W_ih + b_ih`` as one ``torch.matmul`` outside
  the recurrence, where the JAX package computes it
  (``inpaintnet_tpu/ops/gru.py:193``), then K8 (``ops/gru_kernel.py
  gru_layer_stream``: its plain version on the CPU). Its gates run in f32
  with the carry rounded to the parameter dtype, so in bf16 it rounds
  otherwise than ``"xla"``, as the JAX package's two routes do. K8 takes
  every width, as the JAX package's route has no width gate
  (``kernel_common.gru_layer_width``: narrow ones on zero units, wider than
  1024 on tile groups that span clusters). Under a gradient K8
  computes the forward and the eager loop's backward runs on the same
  inputs (``kernel_common.kernel_with_eager_grad``, as for every kernel
  route), so a differentiated ``"pallas"`` call gets the ``"xla"`` route's
  gradients.
The JAX package's ``"trainfast"`` names select its training route, which
the port takes with ``train=True``: they leave the inference route at
``"xla"``.

Training (``train=True``, whatever the route): an unmasked layer of any
width (``gru_train_kernel.trainfast_supports``) runs through the
minimal-residual autograd Function of ``ops/gru_trainfast.py`` (K5 and K6
on the card), as the JAX package's trainers scope every mask-free layer
through ``gru_layer_trainfast`` (``inpaintnet_tpu/ops/gru.py:151-160``); a
masked layer keeps the eager loop, which autograd differentiates. The gate
reads the width alone, so the CPU takes the card's route. Between layers, ``dropout`` drops each
output of every non-last layer with a keep mask drawn from an explicit
``torch.Generator`` (or given as ``dropout_masks``), and scales the kept
ones by ``1 / (1 - p)`` (``gru.py:411-421``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch

from inpaintnet_tpu_torch.ops.distributions import apply_dropout, draw
from inpaintnet_tpu_torch.ops.gru_kernel import gru_layer_stream
from inpaintnet_tpu_torch.ops.gru_train_kernel import trainfast_supports
from inpaintnet_tpu_torch.ops.kernel_common import kernel_with_eager_grad
from inpaintnet_tpu_torch.ops.linear import xavier_normal

_IMPLS = ("xla", "pallas")


def _checked(impl: str) -> str:
    if impl.startswith("trainfast"):
        return "xla"
    if impl not in _IMPLS:
        raise ValueError(f"GRU route must be one of {_IMPLS} (or a trainfast name), got {impl!r}")
    return impl


_GRU_IMPL = os.environ.get("INPAINTNET_GRU_IMPL", "xla")


def set_gru_impl(impl: str) -> None:
    global _GRU_IMPL
    _GRU_IMPL = _checked(impl)


def get_gru_impl() -> str:
    return _checked(_GRU_IMPL)


@contextlib.contextmanager
def gru_impl_scope(impl: Optional[str]):
    """The inference route inside the ``with`` block (``None``: unchanged)."""
    global _GRU_IMPL
    if impl is None:
        yield
        return
    old, _GRU_IMPL = _GRU_IMPL, _checked(impl)
    try:
        yield
    finally:
        _GRU_IMPL = old


def gru_cell_init(rng: np.random.Generator, input_size: int, hidden_size: int) -> dict:
    return {
        "w_ih": xavier_normal(rng, (input_size, 3 * hidden_size)),
        "w_hh": xavier_normal(rng, (hidden_size, 3 * hidden_size)),
        "b_ih": np.zeros((3 * hidden_size,), np.float32),
        "b_hh": np.zeros((3 * hidden_size,), np.float32),
    }


def gru_init(rng: np.random.Generator, input_size: int, hidden_size: int,
             num_layers: int, bidirectional: bool = False) -> list:
    """Init a (possibly bidirectional) multi-layer GRU stack as numpy."""
    num_dirs = 2 if bidirectional else 1
    return [
        [gru_cell_init(rng, input_size if layer == 0 else hidden_size * num_dirs,
                       hidden_size)
         for _ in range(num_dirs)]
        for layer in range(num_layers)
    ]


def gru_cell_apply(params, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One GRU step. h: (B, H), x: (B, in) -> the new h (B, H)."""
    return gru_gates(params, h, x @ params["w_ih"] + params["b_ih"])


def gru_gates(params, h: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """One step's gate math given ``xw = x @ W_ih + b_ih``, in the tensors'
    own dtype (the JAX package's XLA scan does the same)."""
    hidden = h.shape[-1]
    hw = h @ params["w_hh"] + params["b_hh"]
    r = torch.sigmoid(xw[..., :hidden] + hw[..., :hidden])
    z = torch.sigmoid(xw[..., hidden : 2 * hidden] + hw[..., hidden : 2 * hidden])
    n = torch.tanh(xw[..., 2 * hidden :] + r * hw[..., 2 * hidden :])
    return (1.0 - z) * n + z * h


def gru_layer_apply(params, x: torch.Tensor, h0: torch.Tensor, *, reverse: bool = False,
                    mask: Optional[torch.Tensor] = None, want_ys: bool = True,
                    train: bool = False, impl: Optional[str] = None):
    """Single-direction GRU over a sequence.

    :param x: (B, T, in); h0: (B, H)
    :param reverse: run t = T-1 .. 0 (outputs stay in original order)
    :param mask: optional (B, T); steps with mask == 0 keep h
    :param train: the training route (an unmasked layer that
        ``trainfast_supports`` takes runs the trainfast autograd Function,
        any other the eager loop)
    :param impl: the inference route, ``"xla"`` or ``"pallas"`` (default:
        the global one, see the module docstring)
    :return: (outputs (B, T, H) or None, h_last (B, H))
    """
    if train and mask is None and trainfast_supports(params["w_hh"].shape[0]):
        from inpaintnet_tpu_torch.ops.gru_trainfast import gru_layer_trainfast

        ys, h_last = gru_layer_trainfast(params, x, h0, reverse=reverse)
        return (ys if want_ys else None), h_last
    xw = x @ params["w_ih"] + params["b_ih"]  # one product for all T
    if not train and _checked(impl or _GRU_IMPL) == "pallas":
        # K8's forward; under a gradient, the eager loop's backward at the
        # same inputs (K8 builds no graph: kernel_with_eager_grad, as every
        # other kernel route), so x, h0 and the weights get theirs
        def outputs(layer):
            def run(xw, w_hh, b_hh, h0, mask):
                ys, h = layer(xw, w_hh, b_hh, h0, mask, reverse=reverse, want_ys=want_ys)
                return (ys, h) if want_ys else h
            return run
        out = kernel_with_eager_grad(outputs(gru_layer_stream), outputs(_eager_layer))(
            xw, params["w_hh"], params["b_hh"], h0.contiguous(), mask)
        return out if want_ys else (None, out)
    return _eager_layer(xw, params["w_hh"], params["b_hh"], h0, mask, reverse=reverse,
                        want_ys=want_ys)


def _eager_layer(xw: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor,
                 mask: Optional[torch.Tensor], *, reverse: bool, want_ys: bool):
    """The ``"xla"`` route's loop over ``xw = x @ W_ih + b_ih``: the gates
    in the tensors' own dtype, a step whose mask is 0 keeping h. -> (outputs
    (B, T, H) or None, h_last (B, H))"""
    params = {"w_hh": w_hh, "b_hh": b_hh}
    seq_len = xw.shape[1]
    keep = None if mask is None else (mask > 0)[..., None]
    h = h0
    ys = [None] * seq_len
    for t in (range(seq_len - 1, -1, -1) if reverse else range(seq_len)):
        h_new = gru_gates(params, h, xw[:, t])
        h = h_new if keep is None else torch.where(keep[:, t], h_new, h)
        ys[t] = h
    if not want_ys:
        return None, h
    return torch.stack(ys, dim=1), h


def gru_layer_bidir_fused(p_fwd, p_bwd, x: torch.Tensor, h0_pair: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None):
    """Both directions of a bidirectional GRU layer in one loop (the JAX
    package's ``gru_layer_bidir_fused``): step t advances the forward carry
    at t and the backward one at T-1-t with one batched (2, B, H) x
    (2, H, 3H) product. The outputs of two directional
    :func:`gru_layer_apply` calls, in plain PyTorch.

    :param x: (B, T, in); h0_pair: (2, B, H); mask: optional (B, T)
    :return: (outputs (B, T, 2H), forward then backward; h_last (2, B, H))
    """
    w_ih = torch.stack([p_fwd["w_ih"], p_bwd["w_ih"]])  # (2, in, 3H)
    b_ih = torch.stack([p_fwd["b_ih"], p_bwd["b_ih"]])
    stacked = {"w_hh": torch.stack([p_fwd["w_hh"], p_bwd["w_hh"]]),
               "b_hh": torch.stack([p_fwd["b_hh"], p_bwd["b_hh"]])[:, None, :]}
    xw = torch.einsum("bti,dik->dbtk", x, w_ih) + b_ih[:, None, None, :]
    seq_len = x.shape[1]
    h = h0_pair
    fwd, bwd = [None] * seq_len, [None] * seq_len
    for t in range(seq_len):
        back = seq_len - 1 - t
        h_new = gru_gates(stacked, h, torch.stack([xw[0, :, t], xw[1, :, back]]))
        if mask is not None:
            keep = torch.stack([mask[:, t], mask[:, back]])[..., None] > 0
            h_new = torch.where(keep, h_new, h)
        h = h_new
        fwd[t], bwd[back] = h[0], h[1]
    return torch.cat([torch.stack(fwd, dim=1), torch.stack(bwd, dim=1)], dim=-1), h


def dropout_keep(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """A bool keep mask, each element True with probability ``1 - rate``
    (``jax.random.bernoulli``'s ``uniform < p``)."""
    return draw(torch.rand, shape, generator, device) < (1.0 - rate)


def gru_stack_cell_apply(params, h: torch.Tensor, x: torch.Tensor, *, dropout: float = 0.0,
                         train: bool = False, generator: Optional[torch.Generator] = None,
                         dropout_masks: Optional[Sequence[torch.Tensor]] = None):
    """One step through a stack of unidirectional GRU layers (the
    sequential sampling decoders', where the next input depends on the
    sampled token; ``inpaintnet_tpu/ops/gru.py:286-311``). In training a
    fresh keep mask drops every non-last layer's output at every step,
    torch's ``nn.GRU(dropout=...)`` semantics per call.

    :param params: ``gru_init(..., bidirectional=False)`` stack
    :param h: (num_layers, B, H); :param x: (B, in)
    :param dropout_masks: optional bool (B, H) keep masks, one per non-last
        layer, used instead of drawing from ``generator``
    :return: (new h (num_layers, B, H), top-layer output (B, H))
    """
    num_layers = len(params)
    new_h = []
    inp = x
    for layer in range(num_layers):
        p = params[layer][0]
        h_l = gru_gates(p, h[layer], inp @ p["w_ih"] + p["b_ih"])
        new_h.append(h_l)
        inp = h_l
        if train and dropout > 0.0 and layer < num_layers - 1:
            keep = (dropout_masks[layer] if dropout_masks is not None
                    else dropout_keep(inp.shape, dropout, generator, inp.device))
            inp = apply_dropout(inp, keep, dropout)
    return torch.stack(new_h), inp


def gru_apply(params, x: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
              mask: Optional[torch.Tensor] = None, last_outputs: bool = True,
              dropout: float = 0.0, train: bool = False,
              dropout_masks: Optional[Sequence[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None, impl: Optional[str] = None):
    """Multi-layer (bi)GRU over a sequence.

    :param params: nested list from ``gru_init`` (as tensors)
    :param x: (B, T, in)
    :param h0: (num_layers * num_dirs, B, H) or None for zeros
    :param mask: optional (B, T) validity mask
    :param last_outputs: False skips the last layer's per-step outputs
        (callers that read only ``h_n``); ``outputs`` is then None
    :param dropout: inter-layer dropout probability, applied in training
        only to every layer's output but the last
    :param train: the training route (see the module docstring)
    :param dropout_masks: optional bool keep masks, (B, T, H * num_dirs),
        one per non-last layer, used instead of drawing from ``generator``
    :param generator: draws the keep masks
    :param impl: the inference route of every layer (see the module docstring)
    :return: (outputs (B, T, H * num_dirs) or None, h_n (L * D, B, H))
    """
    num_layers, num_dirs = len(params), len(params[0])
    hidden = params[0][0]["w_hh"].shape[0]
    if h0 is None:
        h0 = x.new_zeros((num_layers * num_dirs, x.shape[0], hidden))
    out = x
    h_n = []
    for layer in range(num_layers):
        want_ys = last_outputs or layer < num_layers - 1
        outs = []
        for d in range(num_dirs):
            o, h_last = gru_layer_apply(params[layer][d], out, h0[layer * num_dirs + d],
                                        reverse=(d == 1), mask=mask, want_ys=want_ys,
                                        train=train, impl=impl)
            outs.append(o)
            h_n.append(h_last)
        out = torch.cat(outs, dim=-1) if want_ys else None
        if train and dropout > 0.0 and layer < num_layers - 1:
            keep = (dropout_masks[layer] if dropout_masks is not None
                    else dropout_keep(out.shape, dropout, generator, out.device))
            out = apply_dropout(out, keep, dropout)
    return out, torch.stack(h_n, dim=0)
