"""The port's public surface against the JAX package's.

Every name the JAX package's ``__init__`` modules export imports from the
port's counterpart (``inpaintnet_tpu/<sub>/__init__.py`` ->
``inpaintnet_tpu_torch/<sub>/__init__.py``), read from their source, so the
list follows the JAX package. The counterparts of the JAX package's other
public functions (the GRU cell and the fused bidirectional layer, the
normal's log density, the tree helpers, the losses, the trainers' hooks,
the wire dtype and the serving quantization mode) hold to JAX's on the
same inputs within 1e-6 (f32, other sum orders) or exactly.
"""
import ast
import importlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from inpaintnet_tpu.ops import gru as jax_gru
from inpaintnet_tpu.ops.distributions import DiagNormal as JaxDiagNormal
from inpaintnet_tpu.ops.quantize import serve_quant_mode as jax_serve_quant_mode
from inpaintnet_tpu.serve import token_wire_dtype as jax_token_wire_dtype
from inpaintnet_tpu.train import metrics as jax_metrics
from inpaintnet_tpu.train.vae_trainer import VAETrainer as JaxVAETrainer
from inpaintnet_tpu_torch.models.base import cast_pytree, flatten_params, unflatten_like
from inpaintnet_tpu_torch.ops import gru as gru_mod
from inpaintnet_tpu_torch.ops.distributions import DiagNormal
from inpaintnet_tpu_torch.ops.quantize import serve_quant_mode, serving_quant
from inpaintnet_tpu_torch.serve import token_wire_dtype
from inpaintnet_tpu_torch.train import metrics
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

import test_torch_arnn_train as arnn_t
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-6

ROOT = Path(__file__).resolve().parents[1] / "inpaintnet_tpu"


def _exports():
    for init in sorted(ROOT.glob("*/__init__.py")):
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    yield init.parent.name, alias.asname or alias.name


EXPORTS = list(_exports())


def test_the_jax_package_exports_names():
    assert len(EXPORTS) > 60 and {"ops", "models", "train", "utils", "data", "eval"} <= {
        sub for sub, _ in EXPORTS}


@pytest.mark.parametrize("sub,name", EXPORTS, ids=[f"{s}.{n}" for s, n in EXPORTS])
def test_port_exports_the_jax_name(sub, name):
    module = importlib.import_module(f"inpaintnet_tpu_torch.{sub}")
    assert getattr(module, name, None) is not None, f"inpaintnet_tpu_torch.{sub}.{name}"


def _t(x):
    return torch.from_numpy(np.array(x))


def _cell(rng, n_in, hidden):
    return {k: rng.standard_normal(shape).astype(np.float32) * 0.3
            for k, shape in (("w_ih", (n_in, 3 * hidden)), ("w_hh", (hidden, 3 * hidden)),
                             ("b_ih", (3 * hidden,)), ("b_hh", (3 * hidden,)))}


def test_gru_cell_and_fused_bidirectional_layer_match_jax():
    rng = np.random.default_rng(0)
    fwd, bwd = _cell(rng, 5, 8), _cell(rng, 5, 8)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 8)).astype(np.float32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32)
    tf, tb = ({k: _t(v) for k, v in p.items()} for p in (fwd, bwd))
    np.testing.assert_allclose(
        gru_mod.gru_cell_apply(tf, _t(h0[0]), _t(x[:, 0])).numpy(),
        np.asarray(jax_gru.gru_cell_apply(fwd, h0[0], x[:, 0])), atol=ATOL)
    out, h_last = gru_mod.gru_layer_bidir_fused(tf, tb, _t(x), _t(h0), mask=_t(mask))
    j_out, j_last = jax_gru.gru_layer_bidir_fused(fwd, bwd, x, h0, mask=mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(j_last), atol=ATOL)
    # the two directional layers' outputs
    o_f, h_f = gru_mod.gru_layer_apply(tf, _t(x), _t(h0[0]), mask=_t(mask))
    o_b, h_b = gru_mod.gru_layer_apply(tb, _t(x), _t(h0[1]), mask=_t(mask), reverse=True)
    np.testing.assert_allclose(out.numpy(), torch.cat([o_f, o_b], -1).numpy(), atol=ATOL)
    np.testing.assert_allclose(h_last.numpy(), torch.stack([h_f, h_b]).numpy(), atol=ATOL)


def test_log_prob_and_losses_match_jax():
    rng = np.random.default_rng(1)
    loc, x = rng.standard_normal((2, 4, 6)).astype(np.float32)
    scale = rng.random((4, 6)).astype(np.float32) + 0.1
    np.testing.assert_allclose(DiagNormal(_t(loc), _t(scale)).log_prob(_t(x)).numpy(),
                               np.asarray(JaxDiagNormal(loc, scale).log_prob(x)), atol=ATOL)
    w, t = rng.standard_normal((2, 5, 3)).astype(np.float32)
    for name in ("mean_l1_loss", "mean_mse_loss"):
        np.testing.assert_allclose(float(getattr(metrics, name)(_t(w), _t(t))),
                                   float(getattr(jax_metrics, name)(w, t)), atol=ATOL)
    logits = rng.standard_normal((2, 3, 4, 7)).astype(np.float32)
    targets = rng.integers(0, 7, (2, 3, 4))
    assert metrics.mean_crossentropy_loss_alt is metrics.mean_crossentropy_loss
    np.testing.assert_allclose(float(metrics.mean_accuracy_alt(_t(logits), _t(targets))),
                               float(jax_metrics.mean_accuracy_alt(logits, targets)), atol=ATOL)
    z_tilde, z_prior = rng.standard_normal((2, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(float(VAETrainer.compute_mmd_loss(_t(z_tilde), _t(z_prior))),
                               float(JaxVAETrainer.compute_mmd_loss(z_tilde, z_prior)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(VAETrainer.compute_kld_loss(DiagNormal(_t(loc), _t(scale)))),
        float(JaxVAETrainer.compute_kld_loss(JaxDiagNormal(loc, scale))), atol=ATOL)


def test_tree_helpers():
    tree = {"a": [{"w": torch.ones(2, 3)}], "n": torch.arange(3)}
    flat = flatten_params(tree)
    back = unflatten_like(tree, flat)
    assert torch.equal(back["a"][0]["w"], tree["a"][0]["w"])
    with pytest.raises(KeyError, match="a/0/w"):
        unflatten_like(tree, {"n": flat["n"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        unflatten_like(tree, {**flat, "n": np.zeros(4)})
    cast = cast_pytree(tree, torch.bfloat16)
    assert cast["a"][0]["w"].dtype == torch.bfloat16 and cast["n"].dtype == torch.int64


def test_arnn_span_draws_match_jax():
    """``get_num_target_stochastic`` / ``get_num_past_stochastic`` draw JAX's
    stream, and ``get_constraints_location`` draws through them."""
    jmodel, model = arnn_t._models("reg")
    jax_cls, port_cls = arnn_t.TRAINERS["reg"][1], arnn_t.TRAINERS["reg"][3]
    jtr = jax_cls(arnn_t.DATA, jmodel, seed=3)
    tr = port_cls(arnn_t.DATA, model, device="cpu", seed=3)
    for _ in range(5):
        n = tr.get_num_target_stochastic()
        assert n == jtr.get_num_target_stochastic()
        assert tr.get_num_past_stochastic(n, 9) == jtr.get_num_past_stochastic(n, 9)
    tr.get_num_target_stochastic = lambda: 2
    tr.get_num_past_stochastic = lambda num_target, num_measures: 3
    msl = tr.measure_seq_len
    score = np.zeros((2, 1, arnn_t.DATA.n_bars * msl), np.int32)
    _, start, end = tr.get_constraints_location(score)
    assert (start, end) == (4 * msl, 6 * msl)


def test_wire_dtype_and_serving_quant(monkeypatch):
    for vocab in (60, 2**15):
        assert token_wire_dtype(vocab) == jax_token_wire_dtype(vocab)
    monkeypatch.delenv("INPAINTNET_SERVE_QUANT", raising=False)
    assert serve_quant_mode() == jax_serve_quant_mode() == "none"
    monkeypatch.setenv("INPAINTNET_SERVE_QUANT", "int8")
    assert serve_quant_mode() == jax_serve_quant_mode() == "int8"
    with serving_quant("none"):
        assert serve_quant_mode() == "none"
        with serving_quant(None):
            assert serve_quant_mode() == "int8"
    assert serve_quant_mode() == "int8"
    with pytest.raises(ValueError):
        with serving_quant("int4"):
            pass
