"""K8, the generic GRU layer: the port's plain version against the JAX
package's three TPU kernels of that function, run in Pallas interpret mode
on the CPU (``gru_layer_pallas_stream`` K8, ``gru_layer_pallas`` K9,
``gru_layer_pallas_dma`` K10), on the same numpy inputs; the ``"pallas"``
GRU route against the ``"xla"`` one; the route switch; and the per-row key
split of the autoregressive path."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.ops.gru_pallas import (
    gru_layer_pallas,
    gru_layer_pallas_dma,
    gru_layer_pallas_stream,
)
from inpaintnet_tpu_torch.ops import gru as gru_mod
from inpaintnet_tpu_torch.ops import gru_kernel as gk
from inpaintnet_tpu_torch.ops.distributions import row_bits, row_split
from inpaintnet_tpu_torch.ops.gru import gru_apply, gru_impl_scope, gru_init

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
ATOL_F32 = 2e-5  # as tests/test_gru_pallas.py: sums of f32 products in another order
# bf16: ``gk.BOUNDS`` (4 ulps of h's scale on 2% of the elements), the bound
# the kernel is held to on the card. Seen on these cases with one torch
# thread: bit-equal. A carry kept in f32 (planted below) changes 28.7%.
BF16_BOUND = gk.BOUNDS[torch.bfloat16]


def _mask(kind, batch, steps, rng):
    """None, suffix padding (1..T valid), interior zeros, or suffix padding
    with all-zero rows (the engine's "no future context")."""
    if kind is None:
        return None
    lengths = rng.integers(1, steps + 1, batch)
    m = (np.arange(steps)[None] < lengths[:, None]).astype(np.float32)
    if kind == "interior":
        m = (rng.random((batch, steps)) < 0.7).astype(np.float32)
    elif kind == "zero_rows":
        m[::3] = 0.0
    return m


def _case(batch, steps, hidden, mask_kind, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, steps, 3 * hidden)).astype(np.float32),
            (0.3 * rng.standard_normal((hidden, 3 * hidden))).astype(np.float32),
            (0.1 * rng.standard_normal(3 * hidden)).astype(np.float32),
            (0.5 * rng.standard_normal((batch, hidden))).astype(np.float32),
            _mask(mask_kind, batch, steps, rng))


def _torch(arrays, dtype):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype):
    return [None if a is None else jnp.asarray(a).astype(dtype) for a in arrays]


def _to_torch(jax_out, dtype):
    return tuple(None if o is None else torch.from_numpy(np.asarray(o.astype(jnp.float32)))
                 .to(dtype) for o in jax_out)


CASES = [  # batch (8 does not divide 13 or 5), steps, hidden, mask, reverse, want_ys
    (13, 10, 64, "suffix", False, True),
    (13, 10, 64, "interior", True, True),
    (5, 7, 128, "zero_rows", False, False),
    (5, 7, 128, None, True, True),
    (13, 1, 64, "zero_rows", True, True),
]


@pytest.mark.parametrize("batch,steps,hidden,mask,reverse,want_ys", CASES)
def test_plain_k8_matches_jax_k8_f32(batch, steps, hidden, mask, reverse, want_ys):
    arrays = _case(batch, steps, hidden, mask, batch + steps + hidden)
    want = gru_layer_pallas_stream(*_jax(arrays, jnp.float32), reverse=reverse, tile_b=8,
                                   interpret=True, want_ys=want_ys)
    got = gk.gru_layer_reference(*_torch(arrays, torch.float32), reverse=reverse,
                                 want_ys=want_ys)
    assert (got[0] is None) == (not want_ys) and got[1].shape == (batch, hidden)
    for g, w in zip(got, _to_torch(want, torch.float32)):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=ATOL_F32)
    if mask == "zero_rows":  # an all-zero row returns h0 and emits it at every step
        h0 = torch.from_numpy(arrays[3][::3])
        torch.testing.assert_close(got[1][::3], h0, rtol=0, atol=0)
        if want_ys:
            torch.testing.assert_close(got[0][::3], h0[:, None].expand(-1, steps, -1),
                                       rtol=0, atol=0)


def _bf16_agreement(batch, steps, hidden, mask, reverse, want_ys):
    arrays = _case(batch, steps, hidden, mask, batch + steps + hidden)
    want = _to_torch(gru_layer_pallas_stream(*_jax(arrays, jnp.bfloat16), reverse=reverse,
                                             tile_b=8, interpret=True, want_ys=want_ys),
                     torch.bfloat16)
    args = _torch(arrays, torch.bfloat16)
    return args, want, gk.agreement(gk.gru_layer_reference(*args, reverse=reverse,
                                                           want_ys=want_ys), want)


@pytest.mark.parametrize("batch,steps,hidden,mask,reverse,want_ys", CASES)
def test_plain_k8_matches_jax_k8_bf16(batch, steps, hidden, mask, reverse, want_ys):
    _, want, agree = _bf16_agreement(batch, steps, hidden, mask, reverse, want_ys)
    assert all(w is None or w.dtype == torch.bfloat16 for w in want)
    assert gk.within(agree, BF16_BOUND), agree


def test_bf16_bound_rejects_a_carry_kept_in_f32(monkeypatch):
    """The trap of K8: a carry kept in f32 (K5's) instead of rounded to the
    parameter dtype every step, planted in the plain version."""
    args, want, agree = _bf16_agreement(13, 10, 64, "suffix", False, True)
    assert gk.within(agree, BF16_BOUND)
    monkeypatch.setattr(gk, "carry", lambda h, dtype: h)
    planted = gk.agreement(gk.gru_layer_reference(*args), want)
    assert not gk.within(planted, BF16_BOUND), planted


@pytest.mark.parametrize("kernel", ["gru_layer_pallas", "gru_layer_pallas_dma"])
@pytest.mark.parametrize("batch,steps,hidden,mask,reverse", [(13, 10, 64, "interior", True),
                                                             (5, 7, 128, "zero_rows", False)])
def test_plain_k8_matches_jax_k9_and_k10_f32(kernel, batch, steps, hidden, mask, reverse):
    """K9 and K10 compute K8's function; in f32 the plain K8 matches them
    (each pads the batch to its 8-row tile)."""
    fn = {"gru_layer_pallas": gru_layer_pallas, "gru_layer_pallas_dma": gru_layer_pallas_dma}
    arrays = _case(batch, steps, hidden, mask, 7 * batch + steps)
    want = fn[kernel](*_jax(arrays, jnp.float32), reverse=reverse, tile_b=8, interpret=True)
    got = gk.gru_layer_reference(*_torch(arrays, torch.float32), reverse=reverse)
    for g, w in zip(got, _to_torch(want, torch.float32)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("kernel", [gru_layer_pallas, gru_layer_pallas_dma])
def test_jax_k9_and_k10_do_not_trace_in_bf16(kernel):
    """The JAX package's behaviour, which the port does not copy: K9's and
    K10's gate math promotes the carry to f32, and the kernel then stores it
    into a bf16 output ref. (K8 and the port run in bf16.)"""
    arrays = _jax(_case(8, 3, 64, "suffix", 0), jnp.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        kernel(*arrays, tile_b=8, interpret=True)


def _stack(seed, in_dim, hidden, layers):
    rng = np.random.default_rng(seed)
    return [[{k: torch.from_numpy(v + 0.1 * rng.standard_normal(v.shape).astype(np.float32))
              for k, v in d.items()} for d in layer]
            for layer in gru_init(rng, in_dim, hidden, layers, True)]


@pytest.mark.parametrize("mask_kind,last_outputs", [("suffix", True), ("zero_rows", False),
                                                    (None, True)])
def test_pallas_route_matches_xla_route_f32(mask_kind, last_outputs):
    params = _stack(3, 12, 64, 2)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((11, 9, 12)).astype(np.float32))
    h0 = torch.from_numpy((0.5 * rng.standard_normal((4, 11, 64))).astype(np.float32))
    m = _mask(mask_kind, 11, 9, rng)
    mask = None if m is None else torch.from_numpy(m)
    out_x, hn_x = gru_apply(params, x, h0, mask=mask, last_outputs=last_outputs, impl="xla")
    with gru_impl_scope("pallas"):
        out_p, hn_p = gru_apply(params, x, h0, mask=mask, last_outputs=last_outputs)
    torch.testing.assert_close(hn_p, hn_x, rtol=0, atol=1e-5)
    assert (out_p is None) == (not last_outputs)
    if last_outputs:
        torch.testing.assert_close(out_p, out_x, rtol=0, atol=1e-5)
    assert gk.gru_layer_stream.launches == 0  # CPU tensors: the plain version


def test_pallas_route_takes_k8_and_xla_route_does_not(monkeypatch):
    calls = []
    real = gk.gru_layer_reference
    monkeypatch.setattr(gk, "gru_layer_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    params = _stack(5, 6, 64, 2)
    x = torch.zeros((3, 4, 6))
    gru_apply(params, x, impl="xla")
    assert not calls
    gru_apply(params, x, impl="pallas")
    assert len(calls) == 4  # 2 layers x 2 directions
    gru_apply(params, x, impl="pallas", train=True)  # training keeps its own route
    assert len(calls) == 4


def test_route_switch():
    assert gru_mod.get_gru_impl() == "xla"
    with gru_impl_scope("pallas"):
        assert gru_mod.get_gru_impl() == "pallas"
        with gru_impl_scope(None):
            assert gru_mod.get_gru_impl() == "pallas"
    assert gru_mod.get_gru_impl() == "xla"
    gru_mod.set_gru_impl("pallas")
    try:
        assert gru_mod.get_gru_impl() == "pallas"
    finally:
        gru_mod.set_gru_impl("xla")
    with gru_impl_scope("trainfast_pallas"):  # the JAX package's training names
        assert gru_mod.get_gru_impl() == "xla"
    with pytest.raises(ValueError, match="GRU route"):
        gru_mod.set_gru_impl("cudnn")
    with pytest.raises(ValueError, match="GRU route"):
        gru_apply(_stack(0, 2, 64, 1), torch.zeros((1, 2, 2)), impl="scan")


def test_route_env_is_read_at_import():
    code = ("from inpaintnet_tpu_torch.ops.gru import get_gru_impl; print(get_gru_impl())")
    for value, want in (("pallas", "pallas"), ("trainfast", "xla")):
        env = {**os.environ, "INPAINTNET_GRU_IMPL": value}
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and res.stdout.strip() == want, res.stderr


def test_agreement_measures():
    ys = torch.tensor([[[0.5, -0.25], [0.75, 0.0]]], dtype=torch.bfloat16)
    hn = torch.tensor([[0.75, 0.0]], dtype=torch.bfloat16)
    moved = ys.clone()
    moved[0, 0, 0] += 2 * gk.BF16_ULP_OF_H  # two ulps of a value in [0.5, 1)
    moved[0, 1, 1] = -0.0  # -0 == +0
    agree = gk.agreement((moved, hn), (ys, hn))
    assert agree == {"max_abs_err": 2 ** -7, "share_changed": 1 / 6}
    assert gk.within(agree, {"max_abs_err": 2 ** -7, "share_changed": 0.2})
    assert not gk.within(agree, {"max_abs_err": 2 ** -7, "share_changed": 0.1})
    assert not gk.within(agree, {"max_abs_err": 2 ** -8, "share_changed": 0.2})
    assert gk.agreement((None, hn.float()), (None, hn.float())) == {"max_abs_err": 0.0}


def test_row_split_is_per_row_and_apart_from_row_bits():
    keys = torch.from_numpy(np.random.default_rng(0).integers(0, 2**32, (6, 2)))
    kids = row_split(keys, 3)
    assert kids.shape == (6, 3, 2) and kids.min() >= 0 and kids.max() < 2**32
    torch.testing.assert_close(row_split(keys[3:4], 3), kids[3:4], rtol=0, atol=0)
    torch.testing.assert_close(row_split(keys.flip(0), 3), kids.flip(0), rtol=0, atol=0)
    assert len({tuple(k) for k in kids.reshape(-1, 2).tolist()}) == 18
    bits = row_bits(keys, 3)
    assert not bool(((kids[..., 0] << 32 | kids[..., 1]) == bits).any())
