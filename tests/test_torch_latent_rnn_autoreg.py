"""The slice as a whole: the autoregressive LatentRNN and the past-only /
future-only ablations against the JAX package's, with JAX's parameters
converted by ``from_jax_params`` and JAX's own rsample noise replayed, on
the CPU in f32, under both GRU routes (``"xla"``: eager loops; ``"pallas"``:
K8's plain version); then the engine and the HTTP server over an
autoregressive model.

hidden 64 takes the K1/K2 routes (their plain versions on the CPU), hidden
16 the eager scans."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.client import InpaintingClient
from inpaintnet_tpu.models.latent_rnn import LatentRNN as JaxLatentRNN
from inpaintnet_tpu.models.latent_rnn import LatentRNNAblations as JaxLatentRNNAblations
from inpaintnet_tpu.models.measure_vae import MeasureVAE as JaxMeasureVAE
from inpaintnet_tpu.models.presets import VocabOnlyDataset as JaxVocabOnlyDataset
from inpaintnet_tpu.models.torch_port import export_latent_rnn
from inpaintnet_tpu_torch.models.convert import from_jax_params
from inpaintnet_tpu_torch.models.latent_rnn import LatentRNNAblations
from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset, build_flagship, build_latent_rnn
from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
from inpaintnet_tpu_torch.serve import InpaintingEngine, chunk_seed
from inpaintnet_tpu_torch.server import InpaintingServer

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-4  # f32 end to end: loops of matmuls in another summation order
VOCAB, EMB, Z = 30, 8, 12
B, MP, MF, MT = 4, 5, 5, 3


def _jax_models(hidden, seed, auto_reg=True, ablation=None):
    rng = np.random.default_rng(seed)
    ds = JaxVocabOnlyDataset(VOCAB)
    vae = JaxMeasureVAE(ds, note_embedding_dim=EMB, num_encoder_layers=2,
                        encoder_hidden_size=hidden, latent_space_dim=Z,
                        num_decoder_layers=2, decoder_hidden_size=hidden)
    vae.init(jax.random.PRNGKey(seed))
    kw = dict(num_rnn_layers=2, rnn_hidden_size=hidden, dropout=0.5, auto_reg=auto_reg,
              max_target=MT)
    model = (JaxLatentRNN(ds, vae, **kw) if ablation is None
             else JaxLatentRNNAblations(ds, vae, type=ablation, **kw))
    model.init(jax.random.PRNGKey(seed + 1))

    def jitter(tree):  # zero biases would hide bias bugs
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
            tree)

    vae.params, model.params = jitter(vae.params), jitter(model.params)
    return vae, model


def _port(jvae, jmodel, hidden, auto_reg=True, ablation=None):
    return build_latent_rnn(VocabOnlyDataset(VOCAB), emb=EMB, hidden=hidden, z_dim=Z, layers=2,
                            vae_params_np=jvae.params, latent_params_np=jmodel.params,
                            auto_reg=auto_reg, ablation=ablation, device="cpu")[1]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    past = rng.integers(0, VOCAB, (B, MP, 24)).astype(np.int32)
    future = rng.integers(0, VOCAB, (B, MF, 24)).astype(np.int32)
    pm = (np.arange(MP)[None] < np.array([[1], [3], [5], [2]])).astype(np.float32)
    fm = (np.arange(MF)[None] < np.array([[0], [2], [5], [4]])).astype(np.float32)  # row 0: no future
    tm = (np.arange(MT)[None] < np.array([[3], [1], [2], [3]])).astype(np.float32)
    return past, future, pm, fm, tm


def _jax_noise(key):
    """JAX's draws at inference: the context rsample (``split(rng, 8)[0]``,
    then ``split(.)[1]``) and each re-encode but the last (``split(rng,
    8)[7]`` -> ``split(., MT)`` -> ``split(., 3)[2]`` -> ``split(.)[1]``)."""
    keys = jax.random.split(key, 8)
    eps = jax.random.normal(jax.random.split(keys[0])[1], (B * (MP + MF), Z))
    step_keys = jax.random.split(keys[7], MT)
    steps = [jax.random.normal(jax.random.split(jax.random.split(k, 3)[2])[1], (B, Z))
             for k in step_keys[:-1]]
    return torch.from_numpy(np.array(eps)), torch.from_numpy(np.stack(steps))


def _compare(jvae, jmodel, model, seed, impl):
    past, future, pm, fm, tm = _inputs(seed)
    key = jax.random.PRNGKey(seed)
    jw, js, jz = jmodel.apply(
        jax.tree_util.tree_map(jnp.asarray, jmodel.params),
        jax.tree_util.tree_map(jnp.asarray, jvae.params),
        jnp.asarray(past), jnp.asarray(future), None, past_mask=pm, future_mask=fm,
        target_mask=tm, train=False, rng=key)
    eps, eps_steps = _jax_noise(key)
    with torch.no_grad(), gru_impl_scope(impl):
        tw, ts, tz = model.apply(
            model.params(), model.vae_model.params(), torch.from_numpy(past),
            torch.from_numpy(future), None, past_mask=torch.from_numpy(pm),
            future_mask=torch.from_numpy(fm), target_mask=torch.from_numpy(tm),
            eps=eps, eps_steps=eps_steps)
    assert ts.shape == (B, MT, 24) and tw.shape == (B, MT, 24, VOCAB) and tz.shape == (B, MT, Z)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("hidden", [16, 64])
def test_autoreg_apply_matches_jax(hidden, impl):
    jvae, jmodel = _jax_models(hidden, seed=4)
    _compare(jvae, jmodel, _port(jvae, jmodel, hidden), 7, impl)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("ablation,auto_reg", [("past", False), ("future", True)])
def test_ablations_match_jax(ablation, auto_reg, hidden, impl):
    jvae, jmodel = _jax_models(hidden, seed=8, auto_reg=auto_reg, ablation=ablation)
    model = _port(jvae, jmodel, hidden, auto_reg, ablation)
    assert isinstance(model, LatentRNNAblations) and model.type == ablation
    assert model.generation_linear.in_features == 2 * hidden
    _compare(jvae, jmodel, model, 9, impl)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_teacher_forced_parallel_matches_jax(impl):
    """``_generate_parallel(seed=)``: an autoregressive model's
    teacher-forced pass (the training branch), one masked GRU pass over
    given inputs, against JAX's."""
    jvae, jmodel = _jax_models(16, seed=10)
    model = _port(jvae, jmodel, 16)
    rng = np.random.default_rng(11)
    context = (0.5 * rng.standard_normal((4, B, 32))).astype(np.float32)  # (L * 2, B, 2H)
    seed = rng.standard_normal((B, MT, Z)).astype(np.float32)
    tm = _inputs(11)[4]
    jw, js, jz = jmodel._generate_parallel(
        jax.tree_util.tree_map(jnp.asarray, jmodel.params),
        jax.tree_util.tree_map(jnp.asarray, jvae.params), jnp.asarray(context), jnp.asarray(tm),
        seed=jnp.asarray(seed), train=False, rng=jax.random.PRNGKey(0))
    with torch.no_grad(), gru_impl_scope(impl):
        tw, ts, tz = model._generate_parallel(
            model.params(), model.vae_model.params(), torch.from_numpy(context),
            torch.from_numpy(tm), seed=torch.from_numpy(seed))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


@pytest.mark.parametrize("auto_reg,ablation", [(True, None), (True, "past"), (False, "future")])
def test_from_jax_params_matches_export_layout(auto_reg, ablation):
    jvae, jmodel = _jax_models(16, seed=1, auto_reg=auto_reg, ablation=ablation)
    ref = export_latent_rnn(jmodel.params, jvae.params)
    sd = from_jax_params(jvae.params, jmodel.params)
    assert set(sd) == set(ref) and ("x_0" in ref) == (not auto_reg)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = _port(jvae, jmodel, 16, auto_reg, ablation)
    assert set(model.state_dict()) == set(ref)
    with pytest.raises(RuntimeError, match="size mismatch"):  # strict: the widths too
        _port(jvae, jmodel, 16, auto_reg, None if ablation else "past")


@pytest.fixture(scope="module")
def autoreg_model():
    return build_flagship(vocab_size=VOCAB, hidden=64, z_dim=8, emb=6, seed=0, device="cpu",
                          auto_reg=True)[2]


def test_final_step_is_peeled(autoreg_model, monkeypatch):
    """One context encode and MT - 1 re-encodes (the last decode feeds
    nothing), MT decodes."""
    model = autoreg_model
    counts = {"encode": 0, "decode": 0}
    enc, dec = model.vae_model.encoder.apply, model.vae_model.decoder.decode_sampling
    monkeypatch.setattr(model.vae_model.encoder, "apply",
                        lambda *a, **k: counts.__setitem__("encode", counts["encode"] + 1)
                        or enc(*a, **k))
    monkeypatch.setattr(model.vae_model.decoder, "decode_sampling",
                        lambda *a, **k: counts.__setitem__("decode", counts["decode"] + 1)
                        or dec(*a, **k))
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 16, 24)).astype(np.int32)
    engine = InpaintingEngine(model, batch_buckets=(2,), dtype="float32")
    engine.inpaint(tokens, 6, 4, seed=1)
    assert counts == {"encode": 1 + model.max_target - 1, "decode": model.max_target}
    with pytest.raises(ValueError, match="non-autoregressive"):
        model.generate_from_context_dists(None, None, None, None, past_mask=None,
                                          future_mask=None, target_mask=None)


def test_row_keys_make_rows_independent(autoreg_model):
    """A row's output depends on its inputs and key alone, at a given batch
    shape (the engine's bucket): the same row beside other rows, with
    other keys, at another position, is bit-equal."""
    model = autoreg_model
    tm = np.ones((B, model.max_target), np.float32)
    mine, others = _inputs(3)[:4], _inputs(5)[:4]
    keys = np.random.default_rng(2).integers(0, 2**32, (B, 2))
    other_keys = np.random.default_rng(6).integers(0, 2**32, (B, 2))

    def run(arrays, k):
        past, future, pm, fm = (torch.from_numpy(a) for a in arrays)
        with torch.no_grad(), gru_impl_scope("pallas"):
            return model.apply(model.params(), model.vae_model.params(), past, future, None,
                               past_mask=pm, future_mask=fm, target_mask=torch.from_numpy(tm),
                               row_keys=torch.from_numpy(k))

    _, s_all, z_all = run(mine, keys)
    for b in range(B):
        pos = (b + 1) % B
        arrays = [o.copy() for o in others]
        for a, m in zip(arrays, mine):
            a[pos] = m[b]
        k = other_keys.copy()
        k[pos] = keys[b]
        _, s_one, z_one = run(arrays, k)
        torch.testing.assert_close(z_one[pos], z_all[b], rtol=0, atol=0)
        torch.testing.assert_close(s_one[pos], s_all[b], rtol=0, atol=0)
    _, s_other, z_other = run(mine, keys + 1)
    assert not torch.equal(z_other, z_all)
    assert not torch.equal(s_other, s_all)


@pytest.fixture(scope="module")
def engine(autoreg_model):
    return InpaintingEngine(autoreg_model, batch_buckets=(2, 8), dtype="float32")


def _toks(b, m, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, m, 24)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_inpaint_and_hetero(engine, impl):
    reqs = [{"tokens": _toks(2, 16, 0), "start_measure": 8, "num_measures": 2, "seed": 5},
            {"tokens": _toks(3, 12, 1), "start_measure": 4, "num_measures": 6, "seed": 9},
            {"tokens": _toks(1, 16, 2), "start_measure": 2, "num_measures": 1}]
    with gru_impl_scope(impl):
        coalesced = engine.inpaint_hetero(reqs)
        for req, got in zip(reqs, coalesced):
            np.testing.assert_array_equal(got, engine.inpaint_hetero([req], bucket=8)[0])
            s, n, toks = req["start_measure"], req["num_measures"], req["tokens"]
            assert got.min() >= 0 and got.max() < VOCAB
            np.testing.assert_array_equal(got[:, :s], toks[:, :s])
            np.testing.assert_array_equal(got[:, s + n:], toks[:, s + n:])
        tokens = _toks(5, 16, 3)  # above the largest bucket: chunked
        out = engine.inpaint(tokens, 6, 4, seed=3)
        np.testing.assert_array_equal(out, engine.inpaint(tokens, 6, 4, seed=3))
        np.testing.assert_array_equal(out[:, :6], tokens[:, :6])
        assert not np.array_equal(out, engine.inpaint(tokens, 6, 4, seed=4))


def test_engine_variations_tiled_and_fallback(engine):
    tokens = _toks(2, 16, 4)
    var = engine.inpaint_variations(tokens, 6, 4, num_variations=3, seed=2)  # 6 rows: tiled
    assert var.shape == (3, 2, 16, 24)
    tiled = engine.inpaint_hetero([{"tokens": np.tile(tokens, (3, 1, 1)), "start_measure": 6,
                                    "num_measures": 4, "seed": 2}])[0]
    np.testing.assert_array_equal(var, tiled.reshape(3, 2, 16, 24))
    assert len({v[:, 6:10].tobytes() for v in var}) == 3
    big = engine.inpaint_variations(tokens, 6, 4, num_variations=5, seed=2)  # 10 rows: full passes
    assert big.shape == (5, 2, 16, 24)
    for i, v in enumerate(big):
        np.testing.assert_array_equal(v, engine.inpaint(tokens, 6, 4, seed=chunk_seed(2, i)))
        np.testing.assert_array_equal(v[:, :6], tokens[:, :6])


def test_warmup_skips_variations(autoreg_model):
    engine = InpaintingEngine(autoreg_model, batch_buckets=(1, 2), dtype="bfloat16")
    engine.warmup(hetero=True)
    assert set(engine._compiled) == {1, 2, ("hetero", 1), ("hetero", 2)}


def test_server_over_an_autoregressive_engine(engine):
    """The port's server needs no change: concurrent /v1/inpaint responses
    equal the solo inpaint_hetero; variation 0 equals the seeded inpaint."""
    server = InpaintingServer(engine, port=0, batching=True, pin_bucket=8, max_wait_ms=50)
    port = server.start()
    try:
        reqs = [(_toks(1, 16 - i % 4, 10 + i), 1 + i % 5, 1 + i % 3, 100 + i) for i in range(6)]
        results, errors = [None] * len(reqs), []

        def worker(i):
            try:
                with InpaintingClient("127.0.0.1", port) as c:
                    tokens, start, num, seed = reqs[i]
                    results[i] = c.inpaint(tokens, start, num, seed=seed)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        for (tokens, start, num, seed), got in zip(reqs, results):
            want = engine.inpaint_hetero([{"tokens": tokens, "start_measure": start,
                                           "num_measures": num, "seed": seed}], bucket=8)[0]
            np.testing.assert_array_equal(got, want)
        with InpaintingClient("127.0.0.1", port) as c:
            tokens = _toks(2, 12, 20)
            var = c.inpaint_variations(tokens, 4, 2, num_variations=3, seed=8)
            assert var.shape == (3, 2, 12, 24)
            np.testing.assert_array_equal(var[0], c.inpaint(tokens, 4, 2, seed=8))
    finally:
        server.stop()
