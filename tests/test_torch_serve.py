"""The port's serving engine, its parameter conversion and checkpoint
loading, and the rule that the port never imports JAX."""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.latent_rnn import LatentRNN as JaxLatentRNN
from inpaintnet_tpu.models.measure_vae import MeasureVAE as JaxMeasureVAE
from inpaintnet_tpu.models.presets import VocabOnlyDataset as JaxVocabOnlyDataset
from inpaintnet_tpu.models.torch_port import export_latent_rnn
from inpaintnet_tpu_torch.models.base import load_jax_checkpoint
from inpaintnet_tpu_torch.models.convert import from_jax_params, to_functional
from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset, build_flagship, build_latent_rnn
from inpaintnet_tpu_torch.serve import InpaintingEngine, chunk_seed, pick_bucket

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
VOCAB = 30


@pytest.fixture(scope="module")
def jax_models():
    ds = JaxVocabOnlyDataset(VOCAB)
    vae = JaxMeasureVAE(ds, note_embedding_dim=8, encoder_hidden_size=16, latent_space_dim=12,
                        decoder_hidden_size=16)
    vae.init(jax.random.PRNGKey(0))
    model = JaxLatentRNN(ds, vae, num_rnn_layers=2, rnn_hidden_size=16, dropout=0.5)
    model.init(jax.random.PRNGKey(1))
    return vae, model


@pytest.fixture(scope="module")
def port_model():
    return build_flagship(vocab_size=VOCAB, hidden=16, z_dim=8, emb=6, seed=0, device="cpu")[2]


def test_from_jax_params_matches_export_layout(jax_models):
    jvae, jmodel = jax_models
    ref = export_latent_rnn(jmodel.params, jvae.params)
    sd = from_jax_params(jvae.params, jmodel.params)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    _, model = build_latent_rnn(VocabOnlyDataset(VOCAB), emb=8, hidden=16, z_dim=12, layers=2,
                                vae_params_np=jvae.params, latent_params_np=jmodel.params,
                                device="cpu")
    assert set(model.state_dict()) == set(ref)


def test_loads_are_strict(jax_models, port_model):
    jvae, jmodel = jax_models
    sd = from_jax_params(jvae.params, jmodel.params)
    _, model = build_latent_rnn(VocabOnlyDataset(VOCAB), emb=8, hidden=16, z_dim=12, layers=2,
                                vae_params_np=jvae.params, latent_params_np=jmodel.params,
                                device="cpu")
    missing = dict(sd)
    missing.pop("vae_model.decoder.x_0")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(missing, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict({**sd, "extra.weight": torch.zeros(1)}, strict=True)
    with pytest.raises(KeyError, match="unexpected"):
        to_functional({**model.vae_model.state_dict(), "extra": torch.zeros(1)},
                      model.vae_model.leaves())


def test_load_jax_checkpoint_round_trip(jax_models, tmp_path):
    jvae, jmodel = jax_models
    jvae.save(str(tmp_path / "vae.npz"))
    jmodel.save(str(tmp_path / "latent.npz"))
    sd = from_jax_params(load_jax_checkpoint(str(tmp_path / "vae.npz")),
                         load_jax_checkpoint(str(tmp_path / "latent.npz")))
    direct = from_jax_params(jvae.params, jmodel.params)
    assert set(sd) == set(direct)
    for k in direct:
        torch.testing.assert_close(sd[k], direct[k], rtol=0, atol=0)


def _tokens(batch, measures=16, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, measures, 24)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start,num,measures", [(6, 4, 16), (1, 1, 3), (3, 6, 9)])
def test_engine_span_semantics(port_model, dtype, start, num, measures):
    engine = InpaintingEngine(port_model, batch_buckets=(1, 4), dtype=dtype)
    tokens = _tokens(3, measures)
    out = engine.inpaint(tokens, start, num, seed=4)
    assert out.shape == tokens.shape
    assert out.min() >= 0 and out.max() < VOCAB
    np.testing.assert_array_equal(out[:, :start], tokens[:, :start])
    np.testing.assert_array_equal(out[:, start + num:], tokens[:, start + num:])
    np.testing.assert_array_equal(out, engine.inpaint(tokens, start, num, seed=4))


def test_engine_seeds(port_model):
    engine = InpaintingEngine(port_model, batch_buckets=(8,), dtype="float32", seed=9)
    tokens = _tokens(8)
    np.testing.assert_array_equal(engine.inpaint(tokens, 6, 4), engine.inpaint(tokens, 6, 4, seed=9))
    assert not np.array_equal(engine.inpaint(tokens, 6, 4, seed=1),
                              engine.inpaint(tokens, 6, 4, seed=2))


def test_engine_chunks_above_the_largest_bucket(port_model):
    engine = InpaintingEngine(port_model, batch_buckets=(1, 2), dtype="float32")
    tokens = _tokens(5)
    out = engine.inpaint(tokens, 6, 4, seed=3)
    expect = np.concatenate([engine.inpaint(tokens[lo:lo + 2], 6, 4, seed=chunk_seed(3, i))
                             for i, lo in enumerate(range(0, 5, 2))])
    np.testing.assert_array_equal(out, expect)
    assert chunk_seed(3, 0) != chunk_seed(3, 1) and chunk_seed(3, 0) != 3


def test_pick_bucket_and_warmup(port_model):
    assert [pick_bucket((1, 8, 64), n) for n in (1, 2, 8, 9, 64, 100)] == [1, 8, 8, 64, 64, 64]
    InpaintingEngine(port_model, batch_buckets=(2, 1), dtype="float32").warmup()


@pytest.mark.parametrize("tokens,start,num,match", [
    (_tokens(2, 16)[:, :, :23], 6, 4, "tokens must be"),
    (_tokens(2, 16), 0, 4, "past measure"),
    (_tokens(2, 16), 14, 4, "fit in M"),
    (_tokens(2, 16), 6, 7, "num_measures"),
    (_tokens(2, 17), 6, 4, "at most 16"),
    (_tokens(2, 16) + VOCAB, 6, 4, r"\[0, 30\)"),
    (_tokens(2, 16).astype(np.float32), 6, 4, "integers"),
])
def test_engine_validates_requests(port_model, tokens, start, num, match):
    engine = InpaintingEngine(port_model, batch_buckets=(4,), dtype="float32")
    with pytest.raises(ValueError, match=match):
        engine.inpaint(tokens, start, num)


def test_engine_rejects_unported_dtypes(port_model):
    """int8 is served (bf16 masters, the int8 kernels); float16 is not."""
    engine = InpaintingEngine(port_model, batch_buckets=(4,), dtype="int8")
    assert engine._quant == "int8"
    assert engine._vae_params["encoder"]["embedding"]["table"].dtype == torch.bfloat16
    assert InpaintingEngine(port_model, dtype="bfloat16")._quant == "none"
    with pytest.raises(ValueError, match="dtype"):
        InpaintingEngine(port_model, dtype="float16")


def test_port_never_imports_jax():
    """In a fresh interpreter: import every module of the port, serve
    requests on the CPU (f32 ``inpaint``, int8 ``inpaint`` and
    ``inpaint_hetero``), and find no JAX loaded and no kernel launched."""
    code = textwrap.dedent("""
        import pkgutil, sys, importlib
        import numpy as np
        import torch
        torch.set_num_threads(1)  # beside other test processes
        import inpaintnet_tpu_torch
        for m in pkgutil.walk_packages(inpaintnet_tpu_torch.__path__, "inpaintnet_tpu_torch."):
            importlib.import_module(m.name)
        from inpaintnet_tpu_torch.models.presets import build_flagship
        from inpaintnet_tpu_torch.serve import InpaintingEngine
        from inpaintnet_tpu_torch.ops import encoder_kernel, decode_kernel
        model = build_flagship(hidden=64, z_dim=8, seed=0, device="cpu")[2]
        tokens = np.zeros((2, 16, 24), np.int32)
        InpaintingEngine(model, batch_buckets=(2,), dtype="float32").inpaint(tokens, 6, 4)
        int8 = InpaintingEngine(model, batch_buckets=(2,), dtype="int8")
        int8.inpaint(tokens, 6, 4)
        int8.inpaint_hetero([{"tokens": tokens[:1], "start_measure": 6, "num_measures": 4}])
        assert not [m for m in sys.modules if m in ("jax", "inpaintnet_tpu")
                    or m.startswith(("jax.", "inpaintnet_tpu."))]
        assert encoder_kernel.encoder_hn.launches == 0
        assert decode_kernel.decode_sampling.launches == 0
        assert encoder_kernel.encoder_hn_int8.launches == 0
        assert decode_kernel.decode_sampling_int8.launches == 0
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("entry", ["build_flagship", "build_latent_rnn", "MeasureVAE",
                                   "Trainer", "InpaintingEngine", "build_arnn",
                                   "ConstraintModelGaussianReg", "ARNNServingEngine",
                                   "LatentRNN", "LatentRNNAblations",
                                   "AnticipationRNNGaussianRegTrainer",
                                   "AnticipationRNNBaselineTrainer"])
def test_entry_points_default_to_the_card(entry):
    """Entry points run on the card unless the caller asks for the CPU; the
    engines follow their model's device."""
    import inspect

    from inpaintnet_tpu_torch.models.anticipation_rnn import ConstraintModelGaussianReg
    from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN, LatentRNNAblations
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import build_arnn
    from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine
    from inpaintnet_tpu_torch.train import (
        AnticipationRNNBaselineTrainer,
        AnticipationRNNGaussianRegTrainer,
    )
    from inpaintnet_tpu_torch.train.trainer import Trainer

    fn = {"build_flagship": build_flagship, "build_latent_rnn": build_latent_rnn,
          "MeasureVAE": MeasureVAE, "Trainer": Trainer, "InpaintingEngine": InpaintingEngine,
          "build_arnn": build_arnn, "ConstraintModelGaussianReg": ConstraintModelGaussianReg,
          "ARNNServingEngine": ARNNServingEngine, "LatentRNN": LatentRNN,
          "LatentRNNAblations": LatentRNNAblations,
          "AnticipationRNNGaussianRegTrainer": AnticipationRNNGaussianRegTrainer,
          "AnticipationRNNBaselineTrainer": AnticipationRNNBaselineTrainer}[entry]
    default = inspect.signature(fn).parameters["device"].default
    assert default == (None if entry.endswith("Engine") else "cuda")


def _forbidden_imports(path: Path):
    """(line, module) of every ``import``/``from`` in ``path`` naming ``jax``
    or the JAX package ``inpaintnet_tpu`` (the exact name or a submodule;
    ``inpaintnet_tpu_torch`` is the port and passes)."""
    import ast

    def bad(name):
        return any(name == root or name.startswith(root + ".")
                   for root in ("jax", "inpaintnet_tpu"))

    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if bad(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and bad(node.module or ""):
            found.append((node.lineno, node.module))
    return found


def test_port_sources_import_no_jax():
    """Every module of the port and ``chip_smoke.py``, parsed: no import of
    ``jax`` or ``inpaintnet_tpu``, wherever it stands (a function body
    included, which the fresh-interpreter test above cannot reach)."""
    files = sorted((REPO / "inpaintnet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(REPO)): hits for f in files if (hits := _forbidden_imports(f))}
    assert not bad, bad


@pytest.mark.parametrize("source,caught", [
    ("import jax", True), ("import jax.numpy as jnp", True), ("from jax import lax", True),
    ("import inpaintnet_tpu", True), ("from inpaintnet_tpu.server import X", True),
    ("def f():\n    from inpaintnet_tpu import ops", True),
    ("import inpaintnet_tpu_torch.ops", False), ("from inpaintnet_tpu_torch import serve", False),
    ("import jaxlib_like", False), ("from . import gru", False),
])
def test_import_guard_catches_planted_imports(tmp_path, source, caught):
    f = tmp_path / "m.py"
    f.write_text(source + "\n")
    assert bool(_forbidden_imports(f)) == caught
