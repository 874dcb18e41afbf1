"""A gradient through K8 (``gru_layer_apply(impl="pallas")``).

K8's kernel fills new tensors and builds no autograd graph, so a
differentiated ``"pallas"`` layer runs under ``kernel_with_eager_grad``: the
kernel's forward, the ``"xla"`` route's eager loop re-run on the same
inputs for the backward. The gradients of W_ih, W_hh, both biases, x and
h0 are then the eager route's.

- on the CPU, with the wrapper replaced by a version that builds no graph
  (the card's behaviour): every gradient equals the ``"xla"`` route's, bit
  for bit, with masks, in reverse and with ``want_ys`` both ways;
- on the card: K8 launches once, and the gradient reaches the weights
  upstream of the layer, bit for bit the eager route's.

This file imports no JAX, so the card's tests run on a machine without it:

    python -m pytest tests/test_torch_k8_gradient.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import gru as gru_mod
from inpaintnet_tpu_torch.ops import gru_kernel as lk
from inpaintnet_tpu_torch.ops.gru import gru_init

from test_torch_cuda_kernels import cuda  # noqa: F401  (the card's fixture)
from test_torch_hidden_widths import _one_torch_thread  # noqa: F401  (autouse fixture)


def _case(device, dtype, hidden: int, seed: int = 0):
    """A layer's weights, an upstream projection W_up feeding its input,
    inputs, h0, a suffix mask and the loss's fixed weights."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)
    layer = {k: t(v) for k, v in gru_init(rng, 8, hidden, 1)[0][0].items()}
    layer["b_ih"] = t(0.1 * rng.standard_normal(3 * hidden))  # nonzero, so its gradient shows
    up = t(rng.standard_normal((6, 8)) / 3)
    inp = t(rng.standard_normal((5, 7, 6)))
    h0 = t(0.5 * rng.standard_normal((5, hidden)))
    mask = torch.ones((5, 7), device=device)
    mask[1, 4:] = 0
    mask[3] = 0
    wy, wh = t(rng.standard_normal((5, 7, hidden))), t(rng.standard_normal((5, hidden)))
    return layer, up, inp, h0, mask, wy, wh


def _grads(case, impl: str, reverse: bool, masked: bool, want_ys: bool) -> dict:
    """{name: gradient} of a loss linear in the layer's outputs (so the
    cotangents do not depend on the forward's own values) through one
    ``gru_layer_apply`` on ``impl``; x is tanh(inp @ W_up)."""
    layer, up, inp, h0, mask, wy, wh = case
    leaves = {**{k: v.clone().requires_grad_() for k, v in layer.items()},
              "w_up": up.clone().requires_grad_(), "h0": h0.clone().requires_grad_()}
    x = torch.tanh(inp @ leaves["w_up"])
    x.retain_grad()
    params = {k: leaves[k] for k in layer}
    ys, h_last = gru_mod.gru_layer_apply(params, x, leaves["h0"], reverse=reverse,
                                         mask=mask if masked else None, want_ys=want_ys,
                                         impl=impl)
    assert (ys is None) == (not want_ys)
    loss = (h_last.float() * wh.float()).sum()
    if want_ys:
        loss = loss + (ys.float() * wy.float()).sum()
    loss.backward()
    return {**{k: v.grad for k, v in leaves.items()}, "x": x.grad}


def _no_graph(monkeypatch):
    """K8's wrapper as the card runs it: outputs with no autograd graph."""
    real = lk.gru_layer_stream
    calls = []

    def stream(*args, **kwargs):
        calls.append(args[1].shape)
        with torch.no_grad():
            return real(*args, **kwargs)
    monkeypatch.setattr(gru_mod, "gru_layer_stream", stream)
    return calls


@pytest.mark.parametrize("hidden", [16, 100])
@pytest.mark.parametrize("reverse,masked,want_ys", [(False, False, True), (True, True, True),
                                                    (False, True, False)])
def test_pallas_route_returns_the_eager_routes_gradients(monkeypatch, hidden, reverse, masked,
                                                         want_ys):
    calls = _no_graph(monkeypatch)
    case = _case("cpu", torch.float32, hidden, seed=hidden)
    got = _grads(case, "pallas", reverse, masked, want_ys)
    assert calls == [(hidden, 3 * hidden)]
    want = _grads(case, "xla", reverse, masked, want_ys)
    assert got.keys() == want.keys() == {"w_ih", "w_hh", "b_ih", "b_hh", "w_up", "h0", "x"}
    for k in got:
        assert got[k] is not None and got[k].abs().max() > 0, k
        assert torch.equal(got[k], want[k]), k


def test_pallas_route_without_a_gradient_is_the_kernel_call(monkeypatch):
    """With no gradient asked, the route calls the wrapper once and returns
    its outputs as they are (the engines' launches and graph captures are
    unchanged)."""
    calls = _no_graph(monkeypatch)
    layer, up, inp, h0, mask, _, _ = _case("cpu", torch.float32, 64)
    x = torch.tanh(inp @ up)
    with torch.inference_mode():
        ys, h_last = gru_mod.gru_layer_apply(layer, x, h0, mask=mask, impl="pallas")
    xw = x @ layer["w_ih"] + layer["b_ih"]
    want = lk.gru_layer_reference(xw, layer["w_hh"], layer["b_hh"], h0, mask)
    assert calls == [(64, 192)]
    assert torch.equal(ys, want[0]) and torch.equal(h_last, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 100])
def test_gradient_through_k8_matches_the_eager_loop(cuda, dtype, hidden):
    """On the card, ``"pallas"`` launches K8 once for the forward, and W_up
    (upstream of the layer), W_ih, W_hh, both biases and h0 get the
    ``"xla"`` route's gradients, bit for bit, masked and in reverse."""
    case = _case(cuda, dtype, hidden, seed=hidden)
    for reverse, masked, want_ys in ((False, False, True), (True, True, False)):
        before = lk.gru_layer_stream.launches
        got = _grads(case, "pallas", reverse, masked, want_ys)
        torch.cuda.synchronize()
        assert lk.gru_layer_stream.launches == before + 1
        want = _grads(case, "xla", reverse, masked, want_ys)
        for k in got:
            assert torch.equal(got[k], want[k]), (k, reverse, masked)
        assert got["w_up"].abs().max() > 0
