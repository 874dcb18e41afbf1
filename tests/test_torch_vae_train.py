"""MeasureVAE training in the port against the JAX package, on the CPU.

The JAX side runs the package's own ``Encoder.apply(train=True)``,
``decode_teacher_forced``/``decode_sampling(train=True)`` and the
``VAETrainer`` loss (cross-entropy + 0.001 * KLD) under
``gru_impl_scope("trainfast_pallas")``, with K5/K6 in interpret mode, as
``tests/test_training_e2e.py`` runs them. Small size: vocab 30, embedding
6, hidden 16, z 8, 2 layers, dropout 0 (so the two sides need no shared
masks), the rsample noise and the teacher-forcing coin injected. The
port's unmasked training GRUs run the trainfast Function at both widths
(``trainfast_supports``: every width up to 1024; on the card hidden 16
runs K5/K6 at 64 units, on zero units); the loss and gradient comparison
runs at hidden 64, the trajectory at hidden 16.

Bounds, each with its reason, and a planted fault each must reject:

- loss: 2e-5 absolute (``docs/PARITY.md`` §2); f32 on both sides, seen
  0.0 at hidden 64;
- gradients: 2e-5 absolute; f32 sums over at most a few hundred terms in
  another order (seen 7.1e-8 at hidden 64);
- a 3-step Adam trajectory against optax at lr 1e-3: parameters within
  2e-6, a few f32 ulps of parameters below 4 (seen 7.3e-7 at hidden 16);
  the first Adam step moves every element by about lr whatever the
  gradient's size, so the bound holds each update's sign and size as well;
- a K5 carry rounded to bf16 every step breaks the gradient bound (seen
  9.6e-4 at hidden 64) and the trajectory's (seen 3.9e-3 at hidden 16).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inpaintnet_tpu.data import BeatMarkerMetadata, DatasetManager, TickMetadata
from inpaintnet_tpu.data.synthetic import generate_corpus
from inpaintnet_tpu.models.measure_vae import MeasureVAE as JaxMeasureVAE
from inpaintnet_tpu.models.presets import VocabOnlyDataset as JaxVocabOnlyDataset
from inpaintnet_tpu.ops.gru import gru_impl_scope
from inpaintnet_tpu.train import metrics as jax_metrics
from inpaintnet_tpu.train.checkpoints import load_train_state as jax_load_train_state
from inpaintnet_tpu.train.vae_trainer import VAETrainer as JaxVAETrainer
from inpaintnet_tpu_torch.models import measure_vae as tmv
from inpaintnet_tpu_torch.models.base import flatten_params, iter_leaves
from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
from inpaintnet_tpu_torch.train.data import ArrayDataset
from inpaintnet_tpu_torch.train.trainer import EarlyStopping
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

V, E, H, Z = 30, 6, 16, 8
# a width K5/K6 run at without zero units (whole 64-unit blocks)
H_TRAINFAST = 64
ROWS = 6  # measure rows of a batch: 3 windows of 2 bars
LOSS_ATOL = 2e-5
GRAD_ATOL = 2e-5
ADAM_ATOL = 2e-6
LR = 1e-3
GEOMETRY = dict(note_embedding_dim=E, encoder_hidden_size=H, latent_space_dim=Z,
                decoder_hidden_size=H)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("INPAINTNET_PALLAS_INTERPRET", "1")


def _models(hidden):
    """The JAX model (dropout 0, jittered parameters: zero biases would hide
    bias bugs) and the port's holding the same parameters."""
    geometry = {**GEOMETRY, "encoder_hidden_size": hidden, "decoder_hidden_size": hidden}
    jvae = JaxMeasureVAE(JaxVocabOnlyDataset(V), encoder_dropout_prob=0.0,
                         decoder_dropout_prob=0.0, **geometry)
    jvae.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jvae.params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jvae.params)
    port = tmv.MeasureVAE(VocabOnlyDataset(V), encoder_dropout_prob=0.0,
                          decoder_dropout_prob=0.0, device="cpu", **geometry)
    port.set_params(jvae.params)
    return jvae, port


@pytest.fixture(scope="module")
def models():
    return _models(H)


@pytest.fixture(scope="module")
def models_trainfast():
    return _models(H_TRAINFAST)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (ROWS, 24)).astype(np.int32),
            rng.standard_normal((ROWS, Z)).astype(np.float32))


def _jax_loss(jvae):
    """The JAX package's training loss with injected noise and coin."""
    key = jax.random.PRNGKey(0)  # draws nothing at dropout 0

    def loss(params, score, eps, coin):
        z_dist = jvae.encoder.apply(params["encoder"], score, train=True, rng=key)
        z = z_dist.loc + z_dist.scale * eps
        if coin:
            logits, _ = jvae.decoder.decode_teacher_forced(params["decoder"], z, score,
                                                           train=True, rng=key)
        else:
            logits, _ = jvae.decoder.decode_sampling(params["decoder"], z, train=True, rng=key)
        return (jax_metrics.mean_crossentropy_loss(logits, score)
                + JaxVAETrainer.compute_kld_loss(z_dist))

    return loss


_JITTED = {}


def _jax_value_and_grad(jvae, params, score, eps, coin):
    """One compiled loss-and-gradient per coin (tracing runs under the
    scope, which routes both Pallas kernels)."""
    key = (id(jvae), coin)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jax.value_and_grad(
            lambda p, s, e: _jax_loss(jvae)(p, s, e, coin)))
    with gru_impl_scope("trainfast_pallas"):
        return _JITTED[key](jax.tree_util.tree_map(jnp.asarray, params), score, eps)


def _port_trainer(port, n_bars=2, **kw):
    data = ArrayDataset((np.zeros((1, 1, 24 * n_bars), np.int32),), n_bars=n_bars)
    return VAETrainer(data, port, lr=LR, device="cpu", **kw)


def _port_value_and_grad(port, score, eps, coin):
    tr = _port_trainer(port)
    loss, _ = tr.loss_and_metrics(tr.params, torch.from_numpy(score), True,
                                  eps=torch.from_numpy(eps), coin=coin)
    loss.backward()
    return loss.item(), {k: p.grad.numpy() for k, p in iter_leaves(tr.params)}


@pytest.mark.parametrize("coin", [True, False], ids=["teacher_forced", "sampling"])
def test_vae_loss_and_grads_match_jax(interpret, monkeypatch, models_trainfast, coin):
    """At H_TRAINFAST, where every unmasked training GRU runs the trainfast
    Function (K5/K6's plain versions here)."""
    jvae, port = models_trainfast
    score, eps = _batch(1)
    v, g = _jax_value_and_grad(jvae, jvae.params, score, eps, coin)
    want = flatten_params(g)
    got_v, got = _port_value_and_grad(port, score, eps, coin)
    assert set(got) == set(want)
    np.testing.assert_allclose(got_v, float(v), rtol=0, atol=LOSS_ATOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_ATOL, err_msg=k)
    assert max(np.abs(w).max() for w in want.values()) > 1e-2  # gradients are not trivial

    monkeypatch.setattr(gk, "fwd_carry", lambda h: h.to(torch.bfloat16).float())
    _, planted = _port_value_and_grad(port, score, eps, coin)
    assert max(np.abs(planted[k] - want[k]).max() for k in want) > GRAD_ATOL


def _port_trajectory(port, batches):
    tr = _port_trainer(port)
    for score, eps, coin in batches:
        tr.train_step(torch.from_numpy(score), eps=torch.from_numpy(eps), coin=coin)
    return tr


def test_adam_trajectory_matches_optax(interpret, monkeypatch, models):
    """Three Adam steps (teacher-forced, sampling, teacher-forced) against
    optax.adam on the same losses: the parameters after the third step. At
    H every unmasked training GRU layer runs the trainfast Function, so the
    planted fault rounds K5's carry to bf16 every step."""
    jvae, port = models
    batches = [(*_batch(10 + step), coin) for step, coin in enumerate((True, False, True))]
    params = jax.tree_util.tree_map(jnp.asarray, jvae.params)
    opt = optax.adam(LR)
    state = opt.init(params)
    for score, eps, coin in batches:
        _, g = _jax_value_and_grad(jvae, params, score, eps, coin)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = flatten_params(params)
    tr = _port_trajectory(port, batches)
    assert tr.optimizer.state[tr.params["encoder"]["gru"][0][0]["w_hh"]]["step"].item() == 3
    err = max(np.abs(p.detach().numpy() - want[k]).max() for k, p in iter_leaves(tr.params))
    assert err <= ADAM_ATOL, err

    monkeypatch.setattr(gk, "fwd_carry", lambda h: h.to(torch.bfloat16).float())
    planted = _port_trajectory(port, batches)
    assert max(np.abs(p.detach().numpy() - want[k]).max()
               for k, p in iter_leaves(planted.params)) > ADAM_ATOL


@pytest.mark.parametrize("coin", [True, False], ids=["teacher_forced", "sampling"])
def test_decoder_dropout_keep_rate_and_scale(monkeypatch, coin):
    """Every decoder dropout keeps each element with probability 1 - p and
    scales kept ones by 1 / (1 - p): the beat GRU's inter-layer dropout,
    and the tick GRU's (a (B * 4, 6, H) mask in the teacher-forced decode,
    a fresh (B, H) mask every tick in the sampling one). The keep share is
    held within 4 binomial standard deviations of 1 - p; a mask drawn with
    the rate swapped (keep with probability p) breaks that bound."""
    rate = 0.3
    port = tmv.MeasureVAE(VocabOnlyDataset(V), decoder_dropout_prob=rate, device="cpu",
                          **{**GEOMETRY, "decoder_hidden_size": 64})
    params = port.params()
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal((32, Z)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, V, (32, 24)).astype(np.int32))
    seen = []
    apply_dropout = tmv.apply_dropout

    def spy(x, keep, r):
        out = apply_dropout(x, keep, r)
        seen.append((x, keep, out))
        return out

    monkeypatch.setattr(tmv, "apply_dropout", spy)
    monkeypatch.setattr("inpaintnet_tpu_torch.ops.gru.apply_dropout", spy)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        port.decoder.apply(params["decoder"], z, tokens, train=True, coin=coin, generator=gen)
    # the beat GRU, and the tick GRU once (teacher-forced) or every tick
    assert len(seen) == (2 if coin else 1 + 24)
    keep = torch.cat([k.flatten() for _, k, _ in seen]).float()
    for x, k, out in seen:
        torch.testing.assert_close(out, torch.where(k, x / (1 - rate), torch.zeros_like(x)))
        assert torch.equal(out == 0, ~k | (x == 0))

    def within(share, n):
        return abs(share - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)

    assert within(keep.mean().item(), keep.numel())
    swapped = (torch.rand(keep.shape, generator=gen) < rate).float()
    assert not within(swapped.mean().item(), keep.numel())


# --------------------------------------------------------------------------- #
# train_model on the JAX package's synthetic FolkDatasetNBars
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def folk(tmp_path_factory):
    corpus = tmp_path_factory.mktemp("corpus")
    cache = tmp_path_factory.mktemp("cache")
    generate_corpus(str(corpus), num_tunes=2, num_bars=16, seed=1)  # 171 windows
    mgr = DatasetManager(cache_dir=str(cache), corpus_dir=str(corpus))
    ds = mgr.get_dataset("folk_4by4nbars_short", metadatas=[BeatMarkerMetadata(6),
                                                            TickMetadata(6)],
                         num_bars=2, train=True)
    ds.arrays  # noqa: B018 (builds the tensor store)
    return ds, str(tmp_path_factory.mktemp("ckpt"))


def _folk_vae(ds, ckpt, seed=0):
    return tmv.MeasureVAE(ds, checkpoint_dir=ckpt, device="cpu", seed=seed, **GEOMETRY)


def test_array_dataset_batches_equal_folk_loaders(folk):
    ds, _ = folk
    ours = ArrayDataset(ds.arrays, ds.n_bars).data_loaders(16, split=(0.7, 0.2), seed=3)
    theirs = ds.data_loaders(16, split=(0.7, 0.2), seed=3)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for _ in range(2):  # the train shuffle changes per pass, the same way
            for x, y in zip(a, b):
                for u, w in zip(x, y):
                    np.testing.assert_array_equal(u, w)


def test_train_model_learns_saves_and_resumes(folk, monkeypatch, tmp_path):
    """``train_model`` on FolkDatasetNBars: validation loss falls over 2
    epochs; the model checkpoint loads in the JAX package and a JAX
    checkpoint loads in the port, both exactly; the JSONL log has one line
    an epoch; a fresh trainer's ``load_state`` restores the parameters, the
    Adam state and the epoch count exactly."""
    ds, ckpt = folk
    monkeypatch.chdir(tmp_path)
    model = _folk_vae(ds, ckpt)
    trainer = VAETrainer(ds, model, lr=3e-3, device="cpu", seed=1)
    _, val, _ = ds.data_loaders(batch_size=16, split=(0.7, 0.2))
    l0, _ = trainer.loss_and_acc_on_epoch(val, train=False)
    trainer.train_model(batch_size=16, num_epochs=2, split=(0.7, 0.2), run_name="vae")
    l1, a1 = trainer.loss_and_acc_on_epoch(val, train=False)
    assert np.isfinite(l1) and l1 < l0 and 0.0 <= a1 <= 1.0
    assert trainer.epoch == 2
    assert len((tmp_path / "runs" / "vae.jsonl").read_text().splitlines()) == 2

    # the port's checkpoint in the JAX package, and a JAX one in the port
    jvae = JaxMeasureVAE(ds, checkpoint_dir=ckpt, **GEOMETRY)
    assert jvae.filepath == model.filepath
    jvae.init(jax.random.PRNGKey(9))
    jvae.load()
    want = flatten_params(trainer.params)
    got = flatten_params(jvae.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jvae.init(jax.random.PRNGKey(10))
    jvae.save(str(tmp_path / "jax.npz"))
    other = _folk_vae(ds, ckpt, seed=5).load(str(tmp_path / "jax.npz"))
    for k, v in flatten_params(other.params()).items():
        np.testing.assert_array_equal(v, flatten_params(jvae.params)[k], err_msg=k)

    # the train state: the JAX reader takes its params; a resume is exact
    p_jax, _, step = jax_load_train_state(trainer.state_path, jvae.params, None)
    assert step == 2
    for k, v in flatten_params(p_jax).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    resumed = VAETrainer(ds, _folk_vae(ds, ckpt, seed=7), lr=3e-3, device="cpu")
    assert resumed.load_state() == 2 and resumed.epoch == 2
    for (k, p), (_, q) in zip(iter_leaves(resumed.params), iter_leaves(trainer.params)):
        assert torch.equal(p, q), k
        s, t = resumed.optimizer.state[p], trainer.optimizer.state[q]
        assert set(s) == set(t) == {"step", "exp_avg", "exp_avg_sq"}
        for name in s:
            assert torch.equal(s[name], t[name]), (k, name)
    assert os.path.exists(model.filepath)


def test_bf16_compute_keeps_f32_masters(folk):
    ds, ckpt = folk
    trainer = VAETrainer(ds, _folk_vae(ds, ckpt), lr=3e-3, device="cpu",
                         compute_dtype="bfloat16")
    loader, _, _ = ds.data_loaders(batch_size=16, split=(0.7, 0.2))
    loss, acc = trainer.loss_and_acc_on_epoch(loader, train=True)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    for k, p in iter_leaves(trainer.params):
        assert p.dtype == torch.float32 and p.requires_grad, k
    cast = trainer.compute_params()
    assert cast["decoder"]["tick_gru"][0][0]["w_hh"].dtype == torch.bfloat16


def test_early_stopping_counts_tiny_improvements():
    """The reference's detail: an improvement below 1e-5 still counts
    toward the patience."""
    stopper = EarlyStopping(patience=2)
    for loss in (1.0, 1.0 - 5e-6, 1.0 - 8e-6):
        stopper(loss)
    assert stopper.early_stop and stopper.best_score == -1.0
    stopper = EarlyStopping(patience=2)
    for loss in (1.0, 0.9, 0.8):
        stopper(loss)
    assert not stopper.early_stop and stopper.counter == 0
