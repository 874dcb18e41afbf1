"""The int8 slice as a whole, and the serving engine's new model paths,
against the JAX package on the CPU: the port's ``LatentRNN.apply(...,
quant="int8")`` against JAX's ``apply`` under ``serving_quant("int8")``
with its kernel gates opened and its Pallas kernels interpreted, from the
same converted parameters and JAX's own noise; ``encode_context_dists``,
``generate_from_context_dists`` and the engines' ``interpolate``.

hidden 64 takes the port's kernel route (whose CPU branch is the plain
version). Bounds: in f32 everything outside the int8 products agrees to
summation order (1e-4, as ``test_torch_latent_rnn.py``). A last-bit
difference of those f32 sums (they may even differ from run to run: CPU
GEMMs pick their kernels by buffer alignment) that lands on a .5 boundary
flips one int8 carry rounding, and the flip reaches the generated z
through the encoder heads and the context GRUs. In bf16 the two
frameworks also round the plain layers at different places (a bf16 ulp is
2^-8 relative, carried through four GRU stacks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models import measure_vae as jax_mv
from inpaintnet_tpu.models.base import cast_pytree
from inpaintnet_tpu.ops.quantize import serving_quant
from inpaintnet_tpu.serve import InpaintingEngine as JaxEngine
from inpaintnet_tpu.serve import derive_row_keys as jax_derive_row_keys
from inpaintnet_tpu_torch.models.base import cast_params
from inpaintnet_tpu_torch.serve import InpaintingEngine

from test_torch_latent_rnn import VOCAB, Z, _jax_models, _port
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

B, M, MT = 4, 5, 3
ATOL_F32 = 1e-4
# generated z (and context dists), f32 masters, int8 kernels: seen max 1.1e-6
# (median 1.5e-7), and max 2.4e-3 in a run where one carry rounding flipped.
# A flip moves the elements of one row only, so the median stays at the f32
# level: median <= 1e-4, max <= 5e-3 (two flips). The whole int8 effect (the
# port's quant="none" against JAX's int8) is median 3.0e-3 to 3.2e-3, max
# 1.2e-2 to 1.5e-2, and fails both (test_int8_z_bounds_reject_the_bf16_path)
Z_MEDIAN_INT8_F32 = 1e-4
Z_MAX_INT8_F32 = 5e-3
# generated z, bf16 masters: eight bf16 ulps of |z| up to 2 (seen: 2.3e-2)
Z_ATOL_BF16 = 0.125
TOKEN_SHARE = {"float32": 0.95, "bfloat16": 0.9}  # seen: 1.0 and >= 0.975


def _int8_f32_close(got, want) -> bool:
    err = np.abs(np.asarray(got, np.float32) - want)
    return bool(np.median(err) <= Z_MEDIAN_INT8_F32 and err.max() <= Z_MAX_INT8_F32)


@pytest.fixture
def open_jax_gates(monkeypatch):
    """Run the JAX package's int8 kernels on the CPU as its own tests do."""
    monkeypatch.setenv("INPAINTNET_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_mv.Encoder, "_use_pallas", lambda self, p: True)
    monkeypatch.setattr(jax_mv.HierarchicalDecoder, "_use_pallas_decode", lambda self, p: True)


def _batch(seed):
    rng = np.random.default_rng(seed)
    past = rng.integers(0, VOCAB, (B, M, 24)).astype(np.int32)
    future = rng.integers(0, VOCAB, (B, M, 24)).astype(np.int32)
    pm = (np.arange(M)[None] < np.array([[1], [3], [5], [2]])).astype(np.float32)
    fm = (np.arange(M)[None] < np.array([[0], [2], [5], [4]])).astype(np.float32)
    tm = (np.arange(MT)[None] < np.array([[3], [1], [2], [3]])).astype(np.float32)
    return past, future, pm, fm, tm


def _params(jvae, jmodel, model, dtype):
    jp = (jax.tree_util.tree_map(jnp.asarray, jmodel.params),
          jax.tree_util.tree_map(jnp.asarray, jvae.params))
    tp = (cast_params(model.params(), "cpu", getattr(torch, dtype)),
          cast_params(model.vae_model.params(), "cpu", getattr(torch, dtype)))
    if dtype == "bfloat16":
        jp = tuple(cast_pytree(t, jnp.bfloat16) for t in jp)
    return jp, tp


def _np(t):
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _apply_against_jax_int8(dtype, draw, port_quant):
    """JAX ``apply`` under ``serving_quant("int8")`` and the port's ``apply``
    with ``quant=port_quant`` on JAX's noise. -> (port tokens, port z, JAX
    tokens, JAX z), as numpy (z in f32)."""
    jvae, jmodel = _jax_models(64, seed=4)
    _, model = _port(jvae, jmodel, 64)
    past, future, pm, fm, tm = _batch(5)
    (jp, jvp), (tp, tvp) = _params(jvae, jmodel, model, dtype)
    key = jax.random.PRNGKey(7)
    row_keys = jax_derive_row_keys(11, B) if draw == "row_keys" else None
    with serving_quant("int8"):
        jw, js, jz = jmodel.apply(jp, jvp, jnp.asarray(past), jnp.asarray(future), None,
                                  past_mask=pm, future_mask=fm, target_mask=tm, train=False,
                                  rng=key, row_keys=row_keys)
    # JAX's rsample noise, in the latent's dtype (get_z_seq)
    jdt = jnp.dtype(dtype)
    if draw == "row_keys":
        eps = jax.vmap(lambda k: jax.random.normal(k, (2 * M, Z), jdt))(jnp.asarray(row_keys))
    else:
        _, r_z = jax.random.split(jax.random.split(key, 8)[0])
        eps = jax.random.normal(r_z, (B * 2 * M, Z), jdt)
    with torch.no_grad():
        tw, ts, tz = model.apply(tp, tvp, torch.from_numpy(past), torch.from_numpy(future),
                                 None, past_mask=torch.from_numpy(pm),
                                 future_mask=torch.from_numpy(fm),
                                 target_mask=torch.from_numpy(tm),
                                 eps=torch.from_numpy(_np(eps).reshape(B * 2 * M, Z).copy()),
                                 quant=port_quant)
    assert ts.shape == (B, MT, 24) and tw.shape == (B, MT, 24, VOCAB)
    return ts.numpy(), tz.float().numpy(), np.asarray(js), _np(jz)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("draw", ["batch_key", "row_keys"])
def test_latent_rnn_apply_int8_matches_jax(open_jax_gates, dtype, draw):
    ts, tz, js, jz = _apply_against_jax_int8(dtype, draw, "int8")
    share = (ts == js).mean()
    assert share >= TOKEN_SHARE[dtype], share
    if dtype == "float32":
        assert _int8_f32_close(tz, jz), np.abs(tz - jz).max()
    else:
        np.testing.assert_allclose(tz, jz, atol=Z_ATOL_BF16)


@pytest.mark.parametrize("draw", ["batch_key", "row_keys"])
def test_int8_z_bounds_reject_the_unquantized_path(open_jax_gates, draw):
    """Control: the port without int8 (quant="none") against JAX's int8
    fails the f32 int8 bounds, so they tell the int8 path from the other."""
    _, tz, _, jz = _apply_against_jax_int8("float32", draw, "none")
    err = np.abs(tz - jz)
    assert np.median(err) > Z_MEDIAN_INT8_F32 and err.max() > Z_MAX_INT8_F32
    assert not _int8_f32_close(tz, jz)


@pytest.mark.parametrize("hidden,quant", [(16, "none"), (64, "none"), (64, "int8")])
def test_context_dists_match_jax(open_jax_gates, hidden, quant):
    """encode_context_dists (loc, scale), then generate_from_context_dists
    with JAX's noise injected (f32 masters)."""
    jvae, jmodel = _jax_models(hidden, seed=6)
    _, model = _port(jvae, jmodel, hidden)
    past, future, pm, fm, tm = _batch(8)
    (jp, jvp), (tp, tvp) = _params(jvae, jmodel, model, "float32")
    with serving_quant(quant):
        jd = jmodel.encode_context_dists(jvp, jnp.asarray(past), jnp.asarray(future))
        key = jax.random.PRNGKey(3)
        jw, js, jz = jmodel.generate_from_context_dists(
            jp, jvp, *jd, past_mask=pm, future_mask=fm, target_mask=tm, rng=key)
    keys = jax.random.split(key, 3)
    eps = tuple(torch.from_numpy(_np(jax.random.normal(k, d[0].shape, d[0].dtype)))
                for k, d in zip(keys[:2], jd))
    with torch.no_grad():
        td = model.encode_context_dists(tvp, torch.from_numpy(past), torch.from_numpy(future),
                                        quant)
        tw, ts, tz = model.generate_from_context_dists(
            tp, tvp, *td, past_mask=torch.from_numpy(pm), future_mask=torch.from_numpy(fm),
            target_mask=torch.from_numpy(tm), eps=eps, quant=quant)
    for (tl, tsc), (jl, jsc) in zip(td, jd):
        assert tl.shape == (B, M, Z)
    pairs = [(t.numpy(), _np(j)) for t, j in zip((*td[0], *td[1], tz), (*jd[0], *jd[1], jz))]
    if quant == "none":
        for got, want in pairs:
            np.testing.assert_allclose(got, want, atol=ATOL_F32)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        for got, want in pairs:
            assert _int8_f32_close(got, want), np.abs(got - want).max()
        assert (ts.numpy() == np.asarray(js)).mean() >= TOKEN_SHARE["float32"]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_interpolate_matches_jax_engine(open_jax_gates, dtype):
    """f32: deterministic on both sides, tokens equal. int8 (bf16 masters,
    gates open): tokens equal on a share (seen: 1.0)."""
    jvae, jmodel = _jax_models(64, seed=9)
    _, model = _port(jvae, jmodel, 64)
    pair = np.random.default_rng(10).integers(0, VOCAB, (2, 24)).astype(np.int32)
    want = JaxEngine(jmodel, batch_buckets=(4,), dtype=dtype).interpolate(pair[0], pair[1], 9)
    engine = InpaintingEngine(model, batch_buckets=(4,), dtype=dtype)
    got = engine.interpolate(pair[0], pair[1], 9)
    assert got.shape == (11, 24) and got.dtype == np.int32
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= 0.9
    np.testing.assert_array_equal(got, engine.interpolate(pair[0], pair[1], 9))
    assert "interp" in engine._compiled
    with pytest.raises(ValueError, match="num_points"):
        engine.interpolate(pair[0], pair[1], engine.MAX_INTERP + 1)
