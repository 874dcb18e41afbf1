"""The port's testers and joint evaluation against the JAX package's, on
checkpoints the JAX package initialises and saves and both packages load,
over a 10-tune synthetic corpus at tiny widths (H 16, z 12, a 1-layer VAE).

Each test injects JAX's rsample noise (the key derivations of
``inpaintnet_tpu/models``: ``fold_in(PRNGKey(seed), batch)`` per batch,
then the model's own splits), so the losses must agree within 2e-5 and the
accuracies and tokens exactly.
"""
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from inpaintnet_tpu.data import BeatMarkerMetadata as JaxBeat
from inpaintnet_tpu.data import DatasetManager as JaxManager
from inpaintnet_tpu.data import TickMetadata as JaxTick
from inpaintnet_tpu.data.synthetic import generate_corpus
from inpaintnet_tpu.eval import AnticipationRNNTester as JaxARNNTester
from inpaintnet_tpu.eval import EvalReport as JaxReport
from inpaintnet_tpu.eval import LatentRNNTester as JaxLatentTester
from inpaintnet_tpu.eval import VAETester as JaxVAETester
from inpaintnet_tpu.eval import build_report as jax_build_report
from inpaintnet_tpu.models import AnticipationRNNBaseline as JaxBaseline
from inpaintnet_tpu.models import ConstraintModelGaussianReg as JaxReg
from inpaintnet_tpu.models import LatentRNN as JaxLatentRNN
from inpaintnet_tpu.models import LatentRNNAblations as JaxAblations
from inpaintnet_tpu.models import MeasureVAE as JaxVAE
from inpaintnet_tpu_torch.cli import test_reconstruction as port_joint
from inpaintnet_tpu_torch.data import BeatMarkerMetadata, DatasetManager, TickMetadata
from inpaintnet_tpu_torch.eval import (
    AnticipationRNNTester,
    EvalReport,
    LatentRNNTester,
    VAETester,
    build_report,
)
from inpaintnet_tpu_torch.models.anticipation_rnn import (
    AnticipationRNNBaseline,
    ConstraintModelGaussianReg,
)
from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN, LatentRNNAblations
from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-5
Z = 12
VAE_KW = dict(note_embedding_dim=8, num_encoder_layers=1, encoder_hidden_size=16,
              latent_space_dim=Z, num_decoder_layers=1, decoder_hidden_size=16)
ARNN_KW = dict(note_embedding_dim=8, metadata_embedding_dim=4, num_lstm_constraints_units=16,
               num_lstm_generation_units=16, linear_hidden_size=12, num_layers=2,
               unary_constraint=True)


def _root_joint_eval():
    """The JAX package's root ``test_reconstruction.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_test_reconstruction", os.path.join(REPO, "test_reconstruction.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The corpus, each package's dataset over it, and the JAX package's
    checkpoints: the VAE, the LatentRNN in both modes, the past ablation
    and both ARNNs. -> (jax dataset, port dataset, {name: (jax model,
    port model)})"""
    corpus = str(tmp_path_factory.mktemp("corpus"))
    cache = str(tmp_path_factory.mktemp("cache"))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    generate_corpus(corpus, num_tunes=10, num_bars=16, seed=2)
    jds = JaxManager(cache_dir=cache, corpus_dir=corpus).get_dataset(
        "folk_4by4nbars_short", metadatas=[JaxBeat(6), JaxTick(6)], num_bars=16, train=True)
    tds = DatasetManager(cache_dir=cache, corpus_dir=corpus).get_dataset(
        "folk_4by4nbars_short", metadatas=[BeatMarkerMetadata(6), TickMetadata(6)],
        num_bars=16, train=True)
    np.testing.assert_array_equal(jds.arrays[0], tds.arrays[0])

    jvae = JaxVAE(jds, checkpoint_dir=ckpt, **VAE_KW)
    jvae.init(jax.random.PRNGKey(0))
    jvae.save()
    tvae = MeasureVAE(tds, device="cpu", checkpoint_dir=ckpt, **VAE_KW).load()
    models = {"vae": (jvae, tvae)}
    for name, auto_reg, ablation, key in (("latent", False, None, 1), ("autoreg", True, None, 2),
                                          ("past", False, "past", 3)):
        kw = dict(num_rnn_layers=2, rnn_hidden_size=16, dropout=0.5, auto_reg=auto_reg,
                  checkpoint_dir=ckpt)
        jm = (JaxLatentRNN(jds, jvae, **kw) if ablation is None
              else JaxAblations(jds, jvae, type=ablation, **kw))
        jm.init(jax.random.PRNGKey(key))
        jm.save()
        kw.update(device="cpu", dataset=tds)
        tm = (LatentRNN(tvae, **kw) if ablation is None
              else LatentRNNAblations(tvae, type=ablation, **kw)).load()
        models[name] = (jm, tm)
    for name, jcls, tcls, key in (("arnn", JaxReg, ConstraintModelGaussianReg, 4),
                                  ("arnn_baseline", JaxBaseline, AnticipationRNNBaseline, 5)):
        jm = jcls(jds, checkpoint_dir=ckpt, **ARNN_KW)
        jm.init(jax.random.PRNGKey(key))
        jm.save()
        models[name] = (jm, tcls(tds, device="cpu", checkpoint_dir=ckpt, **ARNN_KW).load())
    return jds, tds, models


@pytest.fixture(scope="module")
def jax_testers(env):
    """One JAX tester a model for the whole module: each jits its forward
    per instance, so sharing them compiles each shape once."""
    jds, _, models = env
    testers = {"vae": JaxVAETester(jds, models["vae"][0])}
    for name in ("latent", "autoreg", "past"):
        testers[name] = JaxLatentTester(jds, models[name][0])
    for name in ("arnn", "arnn_baseline"):
        testers[name] = JaxARNNTester(jds, models[name][0])
    return testers


def _fresh(tester, seed=0):
    """A JAX tester as a new one of ``seed`` would be: its split draws and
    its key restarted."""
    tester.seed = seed
    tester._np_rng = np.random.RandomState(seed + (41 if hasattr(tester, "max_context")
                                                   else 53))
    return tester


def _batches(ds, batch_size=8):
    """The test split's batches, materialised so that both packages read
    the same ones (the last one short)."""
    return [tuple(np.asarray(a) for a in b)
            for b in ds.data_loaders(batch_size=batch_size, split=(0.01, 0.01))[2]]


def _latent_noise(key, batch, max_context, auto_reg, max_target=6):
    """The JAX LatentRNN's draws at inference under ``key``: the context
    rsample (``split(key, 8)[0]``, then ``split(.)[1]``) and, autoregressive,
    each re-encode but the last (``split(key, 8)[7]`` -> ``split(., MT)`` ->
    ``split(., 3)[2]`` -> ``split(.)[1]``)."""
    keys = jax.random.split(key, 8)
    out = {"eps": np.asarray(jax.random.normal(
        jax.random.split(keys[0])[1], (batch * 2 * max_context, Z)))}
    if auto_reg:
        step_keys = jax.random.split(keys[7], max_target)
        out["eps_steps"] = np.stack([np.asarray(jax.random.normal(
            jax.random.split(jax.random.split(k, 3)[2])[1], (batch, Z)))
            for k in step_keys[:-1]])
    return out


def _close(a, b, tol=LOSS_TOL):
    assert abs(a - b) <= tol, (a, b)


@pytest.mark.parametrize("alt", [False, True])
def test_vae_tester_matches_jax(env, jax_testers, alt):
    """``loss_and_acc_test`` (``apply``: rsample key ``split(k, 4)[1]``) and
    ``_alt`` (``apply_test``: ``split(k, 3)[1]``) on JAX's draws."""
    jds, tds, models = env
    jvae, tvae = models["vae"]
    batches = _batches(jds)
    assert len(batches) > 1 and batches[-1][0].shape[0] < batches[0][0].shape[0]
    if alt:  # the JAX package runs apply_test op by op: two batches, the last one short
        batches = batches[:1] + batches[-1:]
    jt, tt = jax_testers["vae"], VAETester(tds, tvae)
    key = jax.random.PRNGKey(0)
    noise = [{"eps": np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(key, i), 3 if alt else 4)[1],
        (b[0].shape[0] * 16, Z)))} for i, b in enumerate(batches)]
    if alt:
        (jl, ja), (tl, ta) = jt.loss_and_acc_test_alt(batches), tt.loss_and_acc_test_alt(
            batches, noise=noise)
    else:
        (jl, ja), (tl, ta) = jt.loss_and_acc_test(batches), tt.loss_and_acc_test(
            batches, noise=noise)
    _close(tl, jl)
    assert ta == pytest.approx(ja, abs=1e-12)


def test_vae_tester_probes_match_jax(env, jax_testers, tmp_path):
    """The encoder's means over the test set (no noise), the interpolation
    path's decode, and the PCA plot."""
    jds, tds, models = env
    jvae, tvae = models["vae"]
    jt, tt = jax_testers["vae"], VAETester(tds, tvae)
    jz, jattr = jt.encode_test_set(batch_size=4, num_batches=2)
    tz, tattr = tt.encode_test_set(batch_size=4, num_batches=2)
    np.testing.assert_allclose(tz, jz, atol=LOSS_TOL)
    np.testing.assert_array_equal(tattr, jattr)
    z1 = tt._encode(jds.arrays[0][0, 0, :24][None])[0]
    jpath = jt.decode_mid_point(jax.numpy.asarray(z1.numpy()), jax.numpy.zeros(Z), 3)
    np.testing.assert_array_equal(tt.decode_mid_point(z1, torch.zeros(Z), 3), jpath)
    assert tt.test_interp(n=3).highest_time == 5 * 4
    assert os.path.exists(tt.plot_attribute_dist(out_dir=str(tmp_path)))


def test_split_score_stochastic_matches_jax(env, jax_testers):
    jds, tds, models = env
    jt = _fresh(jax_testers["latent"])
    tt = LatentRNNTester(tds, models["latent"][1])
    for i, (score, _) in enumerate(_batches(jds) * 3):
        fix = 2 if i % 2 else None
        for a, b in zip(tt.split_score_stochastic(score, fix_num_target=fix),
                        jt.split_score_stochastic(score, fix_num_target=fix)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["latent", "autoreg", "past"])
def test_latent_rnn_tester_matches_jax(env, jax_testers, name):
    jds, tds, models = env
    jm, tm = models[name]
    batches = _batches(jds)
    key = jax.random.PRNGKey(0)
    noise = [_latent_noise(jax.random.fold_in(key, i), b[0].shape[0], 16, tm.auto_reg)
             for i, b in enumerate(batches)]
    jl, ja = _fresh(jax_testers[name]).loss_and_acc_test(batches)
    tl, ta = LatentRNNTester(tds, tm).loss_and_acc_test(batches, noise=noise)
    _close(tl, jl)
    assert ta == pytest.approx(ja, abs=1e-12)


def test_tester_noise_is_the_same_on_every_device_call(env):
    """The testers' own draws: a CPU generator seeded by (seed, batch), so
    two calls give the same noise and another batch or seed another."""
    _, tds, models = env
    tt = LatentRNNTester(tds, models["autoreg"][1], seed=3)
    a, b = tt.noise(1, 4), tt.noise(1, 4)
    assert a.keys() == {"eps", "eps_steps"} and a["eps"].shape == (4 * 32, Z)
    assert a["eps_steps"].shape == (5, 4, Z)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(tt.noise(2, 4)["eps"], a["eps"])
    assert not torch.equal(LatentRNNTester(tds, models["autoreg"][1], seed=4)
                           .noise(1, 4)["eps"], a["eps"])


def test_arnn_tester_matches_jax(env, jax_testers):
    jds, tds, models = env
    batches = _batches(jds)
    for name in ("arnn", "arnn_baseline"):
        jm, tm = models[name]
        jl, ja = _fresh(jax_testers[name]).loss_and_acc_test(batches)
        tl, ta = AnticipationRNNTester(tds, tm).loss_and_acc_test(batches)
        _close(tl, jl)
        assert ta == pytest.approx(ja, abs=1e-12)


def test_arnn_generation_forces_the_context(env):
    jds, tds, models = env
    tt = AnticipationRNNTester(tds, models["arnn"][1])
    _, gen, orig = tt.generation_test(temperature=1.5)
    assert gen.shape == (1, 16 * 24) and orig is not None
    score, md, loc = tt.process_batch_data(
        next(iter(tds.data_loaders(batch_size=1, split=(0.70, 0.20))[2])))
    np.testing.assert_array_equal(gen[loc == 1], score[loc == 1])
    st = tds.arrays[0][0]
    _, gen2, _ = tt.generation(tensor_score=st, tensor_metadata=tds.arrays[1][0, 0],
                               start_measure=6, num_measures_gen=4)
    np.testing.assert_array_equal(gen2[0, :6 * 24], st[0, :6 * 24])
    np.testing.assert_array_equal(gen2[0, 10 * 24:], st[0, 10 * 24:])


@pytest.mark.parametrize("ablations", [(), ("past",)])
def test_joint_eval_matches_the_root_script(env, jax_testers, ablations):
    """``cli.test_reconstruction.loss_and_acc_test`` against the root
    script's on the same splits (both split RandomStates start alike) and
    JAX's noise, given to every LatentRNN as the root script draws it:
    every key within 2e-5."""
    jds, tds, models = env
    root = _root_joint_eval()
    batches = _batches(jds)
    key = jax.random.PRNGKey(0)
    noise = [_latent_noise(jax.random.fold_in(key, i), b[0].shape[0], 16, False)
             for i, b in enumerate(batches)]
    jabl = {f"ablation_{a}": _fresh(jax_testers[a]) for a in ablations}
    tabl = {f"ablation_{a}": LatentRNNTester(tds, models[a][1]) for a in ablations}
    want = root.loss_and_acc_test(
        batches, _fresh(jax_testers["latent"]), _fresh(jax_testers["arnn"]),
        _fresh(jax_testers["arnn_baseline"]),
        num_target_measures=2, num_models=4, ablation_testers=jabl)
    predictions = {}
    got = port_joint.loss_and_acc_test(
        batches, LatentRNNTester(tds, models["latent"][1]),
        AnticipationRNNTester(tds, models["arnn"][1]),
        AnticipationRNNTester(tds, models["arnn_baseline"][1]),
        num_target_measures=2, num_models=4, ablation_testers=tabl, noise=noise,
        predictions=predictions)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], float(want[k]))
    assert set(predictions) == {"latent_rnn", "arnn", "arnn_baseline", *tabl}
    assert [p.shape for p in predictions["arnn"]] == [(b[0].shape[0], 2, 24) for b in batches]


def test_context_repeat_flags_match_the_root_script():
    root = _root_joint_eval()
    rng = np.random.default_rng(0)
    score = rng.integers(0, 3, (6, 16 * 24)).astype(np.int32)
    score[:3, 5 * 24:6 * 24] = score[:3, 0:24]  # restated measures
    score[1, 6 * 24:7 * 24] = score[1, 12 * 24:13 * 24]
    for num_past, num_target in ((5, 2), (3, 4), (1, 1)):
        got = port_joint._context_repeat_flags(score, num_past, num_target)
        np.testing.assert_array_equal(got, root._context_repeat_flags(score, num_past,
                                                                      num_target))
    assert port_joint._context_repeat_flags(score, 5, 2)[:3, 0].all()


def _jax_generate_noise(seed, batch, auto_reg=False):
    return _latent_noise(jax.random.PRNGKey(seed), batch, 16, auto_reg)


@pytest.mark.parametrize("name", ["latent", "autoreg"])
def test_generate_matches_jax(env, jax_testers, name):
    """``generate`` on JAX's noise of ``PRNGKey(seed)``: the same tokens,
    with and without a target, and from empty contexts."""
    jds, tds, models = env
    jm, tm = models[name]
    st = jds.arrays[0][:3]
    m = st.reshape(3, 16, 24)
    past, target, future = m[:, :6], m[:, 6:10], m[:, 10:]
    for seed in (0, 5):
        jt, tt = _fresh(jax_testers[name], seed), LatentRNNTester(tds, tm, seed=seed)
        _, jtensor, jorig = jt.generate(past, future, target, 4)
        _, ttensor, torig = tt.generate(past, future, target, 4,
                                        noise=_jax_generate_noise(seed, 3, tm.auto_reg))
        np.testing.assert_array_equal(ttensor, jtensor)
        assert (torig is None) == (jorig is None)
    _, jt2, _ = _fresh(jax_testers[name]).generate(None, None, None, 2)
    _, tt2, _ = LatentRNNTester(tds, tm).generate(None, None, None, 2,
                                                  noise=_jax_generate_noise(0, 1, tm.auto_reg))
    np.testing.assert_array_equal(tt2, jt2)
    assert tt2.shape[1] == 3 + 2 + 1


@pytest.mark.parametrize("tick_range,length", [
    ((24 * 7, 24 * 9), 16), ((24 * 4, 24 * 6), 12), ((0, 24 * 2), 16), ((24 * 14, 24 * 16), 16),
    (None, 16)])
def test_generation_matches_jax(env, jax_testers, tick_range, length):
    """The tick-range API on a full tune, a short (12-measure) one, and a
    range touching either end (returned unchanged), on JAX's noise."""
    jds, tds, models = env
    jm, tm = models["latent"]
    score = jds.arrays[0][1][:, :length * 24]
    jt, tt = _fresh(jax_testers["latent"]), LatentRNNTester(tds, tm)
    tt.noise = lambda index, batch: _jax_generate_noise(0, batch)
    _, jtensor, _ = jt.generation(tensor_score=score, time_index_range_ticks=tick_range)
    _, ttensor, _ = tt.generation(tensor_score=score, time_index_range_ticks=tick_range)
    np.testing.assert_array_equal(np.asarray(ttensor), np.asarray(jtensor))
    assert np.asarray(ttensor).shape == (1, length * 24)
    with pytest.raises(ValueError):
        tt.generation(tensor_score=score, time_index_range_ticks=(24 * 3, 24 * 3))


def test_eval_report_matches_jax(env, jax_testers, tmp_path):
    """``EvalReport`` writes the same document as JAX's; ``build_report``
    the same sections."""
    jds, tds, models = env
    png = tmp_path / "x.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    docs = []
    for cls, name in ((JaxReport, "jax.html"), (EvalReport, "port.html")):
        report = cls()
        report.add_metrics("m", {"loss": 0.25, "label": "<a>"})
        report.add_image("img", str(png))
        report.add_abc("abc", "X:1\nK:C\nCDEF|")
        report.add_note("a & b")
        docs.append(open(report.write(str(tmp_path / name))).read())
    assert docs[0] == docs[1]
    sections = []
    for build, vt, lt, at, name in (
            (jax_build_report, jax_testers["vae"], _fresh(jax_testers["latent"]),
             _fresh(jax_testers["arnn"]), "j.html"),
            (build_report, VAETester(tds, models["vae"][1]),
             LatentRNNTester(tds, models["latent"][1]),
             AnticipationRNNTester(tds, models["arnn"][1]), "t.html")):
        out = build(vae_tester=vt, latent_tester=lt, arnn_tester=at,
                    out_path=str(tmp_path / name), num_samples=2, batch_size=8, plot=False)
        sections.append(re.findall(r"<h2>(.*?)</h2>", open(out).read()))
    assert sections[0] == sections[1] and "LatentRNN (InpaintNet) inpainting" in sections[1]
