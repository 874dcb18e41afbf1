"""K5 and K6 (the training GRU kernels) and the trainfast autograd Function
on the CPU, against the JAX package: ``gru_fwd_seq_pallas`` and
``gru_bwd_seq_pallas`` run in interpret mode, the custom VJP under
``gru_impl_scope("trainfast_pallas")``, as ``tests/test_ops_rnn.py`` runs
them. The same seeded numpy inputs go through both.

Bounds, each with its reason, and a planted fault each must reject:

- f32: max 1e-5, mean 1e-6. Both sides compute in true f32; only the
  summation order of the 16- and 48-deep products differs (seen: max
  7.2e-7, mean 7.8e-8).
- bf16: max 1e-2 (one bf16 ulp of outputs below 2, an output rounding
  flipped by an f32 last bit) and mean 1e-5 (such flips are rare; seen:
  max 4.8e-7, mean 8.3e-11).
- The planted faults, a K5 carry rounded to bf16 every step and a K6
  product on dhw rounded to bf16, move f32 outputs by 2.4e-3 at most and
  2.9e-4 on average or more, far outside both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.ops.gru import gru_apply as jax_gru_apply
from inpaintnet_tpu.ops.gru import gru_impl_scope
from inpaintnet_tpu.ops.gru_bwd_pallas import gru_bwd_seq_pallas, gru_fwd_seq_pallas
from inpaintnet_tpu.ops.gru_trainfast import gru_layer_trainfast as jax_gru_layer_trainfast
from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
from inpaintnet_tpu_torch.ops.gru import gru_apply, gru_init
from inpaintnet_tpu_torch.ops.gru_trainfast import gru_layer_trainfast

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

B, H = 5, 16  # a batch that no tile divides: the ragged edge is exercised
BOUNDS = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1e-2, 1e-5)}  # (max, mean)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRAD_ATOL = 1e-5  # f32 gradients: sums of a few hundred f32 products per element


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("INPAINTNET_PALLAS_INTERPRET", "1")


def _errs(port, jax_out):
    """(max, mean) absolute difference over a sequence of outputs."""
    d = [np.abs(p.float().numpy() - np.asarray(j.astype(jnp.float32)))
         for p, j in zip(port, jax_out)]
    return max(x.max() for x in d), max(x.mean() for x in d)


def _within(errs, dtype):
    return errs[0] <= BOUNDS[dtype][0] and errs[1] <= BOUNDS[dtype][1]


def _fwd_inputs(seq_len, reverse):
    rng = np.random.default_rng(10 * seq_len + reverse)
    return ((0.3 * rng.standard_normal((H, 3 * H))).astype(np.float32),
            (0.1 * rng.standard_normal(3 * H)).astype(np.float32),
            rng.standard_normal((B, seq_len, 3 * H)).astype(np.float32),
            (0.5 * rng.standard_normal((B, H))).astype(np.float32))


def _bwd_inputs(seq_len, reverse, gates):
    """Cotangents and h_prev at random, the stored gates from K5."""
    rng = np.random.default_rng(20 * seq_len + reverse)
    w_hh = (0.3 * rng.standard_normal((H, 3 * H))).astype(np.float32)
    dys = rng.standard_normal((seq_len, B, H)).astype(np.float32)
    hprev = (0.5 * rng.standard_normal((seq_len, B, H))).astype(np.float32)
    return (w_hh, dys, *gates, hprev)


def _run_fwd(inputs, dtype, reverse):
    return gk.gru_fwd_seq_reference(*(torch.tensor(a, dtype=dtype) for a in inputs),
                                    reverse=reverse)


def _run_bwd(inputs, dtype, reverse):
    return gk.gru_bwd_seq_reference(*(torch.tensor(a, dtype=dtype) for a in inputs),
                                    reverse=reverse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seq_len", [4, 6, 24])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_k5_k6_plain_versions_match_jax_kernels(interpret, dtype, seq_len, reverse):
    fwd_in = _fwd_inputs(seq_len, reverse)
    jf = gru_fwd_seq_pallas(*(jnp.asarray(a, JDT[dtype]) for a in fwd_in), reverse=reverse)
    pf = _run_fwd(fwd_in, dtype, reverse)
    assert all(p.shape == (seq_len, B, H) and p.dtype == dtype for p in pf)
    errs = _errs(pf, jf)
    assert _within(errs, dtype), errs

    gates = [np.asarray(g.astype(jnp.float32)) for g in jf[1:]]
    bwd_in = _bwd_inputs(seq_len, reverse, gates)
    jb = gru_bwd_seq_pallas(*(jnp.asarray(a, JDT[dtype]) for a in bwd_in), reverse=reverse)
    pb = _run_bwd(bwd_in, dtype, reverse)
    assert [tuple(p.shape) for p in pb] == [(seq_len, B, 3 * H)] * 2 + [(B, H)]
    errs = _errs(pb, jb)
    assert _within(errs, dtype), errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_k5_k6_bounds_reject_planted_faults(interpret, monkeypatch, dtype, reverse):
    seq_len = 24
    fwd_in = _fwd_inputs(seq_len, reverse)
    jf = gru_fwd_seq_pallas(*(jnp.asarray(a, JDT[dtype]) for a in fwd_in), reverse=reverse)
    gates = [np.asarray(g.astype(jnp.float32)) for g in jf[1:]]
    bwd_in = _bwd_inputs(seq_len, reverse, gates)
    jb = gru_bwd_seq_pallas(*(jnp.asarray(a, JDT[dtype]) for a in bwd_in), reverse=reverse)
    monkeypatch.setattr(gk, "fwd_carry", lambda h: h.to(torch.bfloat16).float())
    assert not _within(_errs(_run_fwd(fwd_in, dtype, reverse), jf), dtype)
    monkeypatch.setattr(gk, "bwd_product", lambda d, w_t: d.to(torch.bfloat16).float() @ w_t)
    assert not _within(_errs(_run_bwd(bwd_in, dtype, reverse), jb), dtype)


def _layer_case(seed, batch=4, seq_len=6, in_dim=7):
    rng = np.random.default_rng(seed)
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in gru_init(rng, in_dim, H, 1)[0][0].items()}
    x = rng.standard_normal((batch, seq_len, in_dim)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((batch, H))).astype(np.float32)
    wy = rng.standard_normal((batch, seq_len, H)).astype(np.float32)
    wh = rng.standard_normal((batch, H)).astype(np.float32)
    return p, x, h0, wy, wh


def _port_layer_grads(p, x, h0, wy, wh, reverse):
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx, th0 = (torch.from_numpy(a).requires_grad_() for a in (x, h0))
    ys, h_last = gru_layer_trainfast(tp, tx, th0, reverse=reverse)
    loss = (ys * torch.from_numpy(wy)).sum() + (h_last * torch.from_numpy(wh)).sum()
    loss.backward()
    return loss.item(), [tp[k].grad.numpy() for k in sorted(tp)] + [tx.grad.numpy(),
                                                                      th0.grad.numpy()]


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_trainfast_function_grads_match_jax_vjp(interpret, monkeypatch, reverse):
    """Values and gradients of ``sum(ys * wy) + sum(h_last * wh)`` against
    the JAX custom VJP with both Pallas kernels: the h_last cotangent reaches
    K6 through ys, and dh0 reaches h0. A K6 product rounded to bf16 breaks
    the gradient bound."""
    p, x, h0, wy, wh = _layer_case(1)

    def loss(p, x, h0):
        ys, h_last = jax_gru_layer_trainfast(p, x, h0, reverse=reverse)
        return jnp.sum(ys * wy) + jnp.sum(h_last * wh)

    with gru_impl_scope("trainfast_pallas"):
        v, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(
            *jax.tree_util.tree_map(jnp.asarray, (p, x, h0)))
    want = [np.asarray(g[0][k]) for k in sorted(p)] + [np.asarray(g[1]), np.asarray(g[2])]
    got_v, got = _port_layer_grads(p, x, h0, wy, wh, reverse)
    np.testing.assert_allclose(got_v, float(v), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)
    assert np.abs(got[-1]).max() > 0.1  # dh0 is not trivially zero

    monkeypatch.setattr(gk, "bwd_product", lambda d, w_t: d.to(torch.bfloat16).float() @ w_t)
    _, planted = _port_layer_grads(p, x, h0, wy, wh, reverse)
    assert max(np.abs(a - b).max() for a, b in zip(planted, want)) > 10 * GRAD_ATOL


# the stack's width: one the trainfast route takes (``trainfast_supports``:
# whole 64-unit chunks); a narrower training layer runs the eager loop
STACK_H = 64


def _stack_case(seed):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32),
        gru_init(rng, 5, STACK_H, 2, bidirectional=True))
    x = rng.standard_normal((4, 6, 5)).astype(np.float32)
    keep = rng.random((4, 6, 2 * STACK_H)) < 0.5
    w_out = rng.standard_normal((4, 6, 2 * STACK_H)).astype(np.float32)
    w_hn = rng.standard_normal((4, 4, STACK_H)).astype(np.float32)
    return params, x, keep, w_out, w_hn


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v, grad) for v in tree]
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _port_stack(params, x, keep, w_out, w_hn):
    tp, tx = _t(params, True), _t(x, True)
    out, h_n = gru_apply(tp, tx, dropout=0.5, train=True, dropout_masks=[torch.from_numpy(keep)])
    loss = (out * _t(w_out)).sum() + (h_n * _t(w_hn)).sum()
    loss.backward()
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp,
                                   is_leaf=lambda t: isinstance(t, torch.Tensor))
    return loss.item(), grads, tx.grad.numpy()


def test_gru_apply_train_with_dropout_masks_matches_jax(interpret, monkeypatch):
    """2-layer bidirectional ``gru_apply(train=True)`` with an injected
    inter-layer keep mask (dropout 0.5): loss and every gradient against
    JAX's under the trainfast Pallas scope. A K5 carry rounded to bf16
    breaks the bound."""
    params, x, keep, w_out, w_hn = _stack_case(2)

    def loss(params, x):
        out, h_n = jax_gru_apply(params, x, dropout=0.5, train=True, dropout_masks=[keep])
        return jnp.sum(out * w_out) + jnp.sum(h_n * w_hn)

    with gru_impl_scope("trainfast_pallas"):
        v, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(
            *jax.tree_util.tree_map(jnp.asarray, (params, x)))
    got_v, tgp, tgx = _port_stack(params, x, keep, w_out, w_hn)
    np.testing.assert_allclose(got_v, float(v), rtol=1e-6)
    np.testing.assert_allclose(tgx, np.asarray(gx), atol=GRAD_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(tgp), jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL)

    monkeypatch.setattr(gk, "fwd_carry", lambda h: h.to(torch.bfloat16).float())
    planted_v, _, _ = _port_stack(params, x, keep, w_out, w_hn)
    assert abs(planted_v - float(v)) > 1e-6 * abs(float(v)) * 10


def test_wrappers_run_plain_versions_on_cpu_only():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing; on another device they refuse rather than fall back."""
    fwd_in = [torch.from_numpy(a) for a in _fwd_inputs(6, False)]
    before = (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches)
    out = gk.gru_fwd_seq(*fwd_in)
    for a, b in zip(out, gk.gru_fwd_seq_reference(*fwd_in)):
        assert torch.equal(a, b)
    assert (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches) == before
    meta = [t.to("meta") for t in fwd_in]
    with pytest.raises(ValueError, match="no kernel for device"):
        gk.gru_fwd_seq(*meta)
