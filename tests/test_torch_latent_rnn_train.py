"""LatentRNN training in the port against the JAX package, on the CPU.

The JAX side runs the package's own ``LatentRNNTrainer`` (its split, its
``loss_and_metrics`` over ``LatentRNN.apply(train=True)``) under its
default GRU route, the XLA scans; the port's side runs
``inpaintnet_tpu_torch.train.LatentRNNTrainer``. Small size: vocab 30,
embedding 6, VAE and LatentRNN hidden 16, z 8, 9 bars, batch 4, jittered
weights. The LatentRNN's dropout and the VAE encoder's are 0, so the two
sides need no shared masks; the VAE decoder's is 0.5, as the frozen VAE of
a real run has it, and a correct decode (``train=False``) never applies it.
JAX's rsample noise (the context's and each re-encode's) and its
teacher-forcing coin are injected into the port.

Bounds, each with its reason, and the planted faults they must reject:

- loss: 2e-5 absolute (``docs/PARITY.md`` §2); f32 on both sides;
- gradients: 2e-5 absolute; f32 sums in another order through a loop of
  GRUs, an argmax decode and re-encodes;
- a 3-step Adam trajectory against optax at lr 1e-3: parameters within
  2e-6, a few f32 ulps of parameters below 4; the first Adam step moves
  every element by about lr whatever the gradient's size, so the bound
  holds each update's sign and size as well;
- planted faults: the decode run in train mode (the decoder's dropout
  then acts), the seed ``zp_last`` taken at the padded last past slot, and
  a tick mask that ignores ``target_mask``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inpaintnet_tpu.data import BeatMarkerMetadata, DatasetManager, TickMetadata
from inpaintnet_tpu.data.synthetic import generate_corpus
from inpaintnet_tpu.models.latent_rnn import LatentRNN as JaxLatentRNN
from inpaintnet_tpu.models.latent_rnn import LatentRNNAblations as JaxLatentRNNAblations
from inpaintnet_tpu.models.measure_vae import MeasureVAE as JaxMeasureVAE
from inpaintnet_tpu.train.latent_rnn_trainer import LatentRNNTrainer as JaxLatentRNNTrainer
from inpaintnet_tpu_torch.models import latent_rnn as tlr
from inpaintnet_tpu_torch.models.base import flatten_params, iter_leaves
from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
from inpaintnet_tpu_torch.ops import gru as gru_mod
from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
from inpaintnet_tpu_torch.train import LatentRNNTrainer
from inpaintnet_tpu_torch.train import latent_rnn_trainer as tlt
from inpaintnet_tpu_torch.train.data import ArrayDataset

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

V, E, H, Z = 30, 6, 16, 8
N_BARS, B, MT = 9, 4, 6
LOSS_ATOL = 2e-5
GRAD_ATOL = 2e-5
ADAM_ATOL = 2e-6
LR = 1e-3
# (ablation, auto_reg, coin): the non-autoregressive model, the
# autoregressive one on each coin, and both ablations
CASES = {
    "plain": (None, False, None),
    "auto_reg_tf": (None, True, True),
    "auto_reg_sampled": (None, True, False),
    "ablation_past": ("past", False, None),
    "ablation_future": ("future", True, False),
}


class Windows(ArrayDataset):
    """In-memory windows with the vocabulary and measure geometry the JAX
    package's models and trainer read."""

    subdivision = 6
    num_beats_per_bar = 4

    def __init__(self, arrays, n_bars: int):
        super().__init__(arrays, n_bars)
        self.note2index_dicts = [{f"N{i}": i for i in range(V)}]

    def __repr__(self):
        return f"Windows({self.n_bars},{V})"


def _windows(seed, n=B):
    return np.random.default_rng(seed).integers(0, V, (n, 1, N_BARS * 24)).astype(np.int32)


DATA = Windows((_windows(0, 8),), N_BARS)


def _models(ablation=None, auto_reg=False, dropout=0.0, enc_dropout=0.0, seed=0):
    """The JAX VAE and LatentRNN (jittered parameters: zero biases would hide
    bias bugs) and the port's holding the same parameters."""
    rng = np.random.default_rng(seed)
    geometry = dict(note_embedding_dim=E, encoder_hidden_size=H, latent_space_dim=Z,
                    decoder_hidden_size=H, encoder_dropout_prob=enc_dropout,
                    decoder_dropout_prob=0.5)
    jvae = JaxMeasureVAE(DATA, **geometry)
    jvae.init(jax.random.PRNGKey(seed))
    kw = dict(num_rnn_layers=2, rnn_hidden_size=H, dropout=dropout, auto_reg=auto_reg,
              max_target=MT)
    jmodel = (JaxLatentRNN(DATA, jvae, **kw) if ablation is None
              else JaxLatentRNNAblations(DATA, jvae, type=ablation, **kw))
    jmodel.init(jax.random.PRNGKey(seed + 1))

    def jitter(tree):
        return jax.tree_util.tree_map(
            lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
            tree)

    jvae.params, jmodel.params = jitter(jvae.params), jitter(jmodel.params)
    vae = MeasureVAE(DATA, device="cpu", **geometry)
    vae.set_params(jvae.params)
    kw = dict(dropout=dropout, dataset=DATA)
    model = (tlr.LatentRNN(vae, 2, H, auto_reg, MT, "cpu", **kw) if ablation is None
             else tlr.LatentRNNAblations(vae, 2, H, auto_reg, MT, "cpu", type=ablation, **kw))
    model.set_params(jmodel.params)
    return jvae, jmodel, model


def _coin_key(want):
    """A step key whose teacher-forcing coin (``split(key, 8)[5]``) is
    ``want``."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(jax.random.split(key, 8)[5], 0.5)) == want:
            return key
    raise AssertionError("no key gives that coin")


def _jax_noise(key, measures):
    """JAX's draws in ``apply``: the context rsample (``split(key, 8)[0]``,
    then ``split(.)[1]``) over B * measures rows, and each re-encode but
    the last (``split(key, 8)[7]`` -> ``split(., MT)`` -> ``split(., 3)[2]``
    -> ``split(.)[1]``)."""
    keys = jax.random.split(key, 8)
    eps = jax.random.normal(jax.random.split(keys[0])[1], (B * measures, Z))
    steps = [jax.random.normal(jax.random.split(jax.random.split(k, 3)[2])[1], (B, Z))
             for k in jax.random.split(keys[7], MT)[:-1]]
    return torch.from_numpy(np.array(eps)), torch.from_numpy(np.stack(steps))


def _jax_trainer(jmodel, seed=0):
    return JaxLatentRNNTrainer(DATA, jmodel, lr=LR, seed=seed)


def _jax_value_and_grad(jtr, jvae, params, batch, key):
    """The JAX trainer's training loss and its gradient, one compile a
    trainer."""
    if not hasattr(jtr, "test_value_and_grad"):
        jtr.test_value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, b, k, e: jtr.loss_and_metrics(p, b, k, True, extra=e)[0]))
    tree = jax.tree_util.tree_map(jnp.asarray, (params, jvae.params))
    return jtr.test_value_and_grad(tree[0], batch, key, tree[1])


def _split(jtr, seed, num_target=3):
    """A fixed split of fresh windows, as the JAX trainer packs it."""
    return jtr.split_score_stochastic(_windows(seed), fix_num_target=num_target)


def _inject(model, key, coin):
    measures = 2 * N_BARS + (MT if model.use_teacher_forcing else 0)
    eps, eps_steps = _jax_noise(key, measures)
    return dict(eps=eps, eps_steps=eps_steps, coin=coin)


def _port_value_and_grad(model, batch, inject):
    tr = LatentRNNTrainer(DATA, model, lr=LR, device="cpu")
    loss, _ = tr.loss_and_metrics(tr.params, tuple(torch.from_numpy(a) for a in batch), True,
                                  extra=tr.extra, **inject)
    loss.backward()
    # an ablation's unused context GRU gets no gradient; JAX's is zero
    return loss.item(), {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
                         for k, p in iter_leaves(tr.params)}


def _grad_err(got, want):
    return max(np.abs(got[k] - want[k]).max() for k in want)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    ablation, auto_reg, coin = CASES[request.param]
    jvae, jmodel, model = _models(ablation, auto_reg)
    return request.param, coin, jvae, jmodel, model, _jax_trainer(jmodel)


def test_loss_and_grads_match_jax(case, monkeypatch):
    name, coin, jvae, jmodel, model, jtr = case
    key = jax.random.PRNGKey(5) if coin is None else _coin_key(coin)
    batch = _split(jtr, 1)
    v, g = _jax_value_and_grad(jtr, jvae, jmodel.params, batch, key)
    want = flatten_params(g)
    inject = _inject(model, key, coin)
    got_v, got = _port_value_and_grad(model, batch, inject)
    assert set(got) == set(want)
    np.testing.assert_allclose(got_v, float(v), rtol=0, atol=LOSS_ATOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_ATOL, err_msg=k)
    # the gradients stand well above the bound
    assert max(np.abs(w).max() for w in want.values()) > 50 * GRAD_ATOL

    # planted faults, one at a time
    decode = model.vae_model.decoder.decode_sampling
    with monkeypatch.context() as m:
        m.setattr(model.vae_model.decoder, "decode_sampling",
                  lambda p, z, quant="none": decode(p, z, quant, train=True))
        v_f, g_f = _port_value_and_grad(model, batch, inject)
        assert abs(v_f - float(v)) > LOSS_ATOL and _grad_err(g_f, want) > GRAD_ATOL
    with monkeypatch.context() as m:
        m.setattr(tlt, "target_tick_mask",
                  lambda tm, n: torch.ones_like(tm)[:, :, None].expand(-1, -1, n))
        v_f, g_f = _port_value_and_grad(model, batch, inject)
        assert abs(v_f - float(v)) > LOSS_ATOL and _grad_err(g_f, want) > GRAD_ATOL
    if model.auto_reg:
        with monkeypatch.context() as m:
            m.setattr(tlr, "last_valid_measure", lambda z, mask: z[:, -1:])
            v_f, g_f = _port_value_and_grad(model, batch, inject)
            assert abs(v_f - float(v)) > LOSS_ATOL and _grad_err(g_f, want) > GRAD_ATOL


def _port_trajectory(model, batches):
    tr = LatentRNNTrainer(DATA, model, lr=LR, device="cpu")
    for batch, inject in batches:
        tr.train_step(tuple(torch.from_numpy(a) for a in batch), **inject)
    return tr


def test_adam_trajectory_matches_optax():
    """Three Adam steps of the non-autoregressive model against optax.adam
    on the same losses: the parameters after the third step, over three
    target lengths.

    The autoregressive model is held by its loss and gradients alone: a
    first Adam step moves an element by lr * g / (|g| + 1e-8), so where a
    gradient element lies far below Adam's eps its rounding error is
    amplified 1e5 times. Seen: a generation-GRU gradient of -9.49e-10 in
    JAX and -9.08e-10 in the port (every gradient within 1.6e-9 of JAX's)
    moved that weight 3.4e-6 apart after one step."""
    jvae, jmodel, model = _models()
    jtr = _jax_trainer(jmodel)
    batches = []
    for step in range(3):
        key = jax.random.PRNGKey(20 + step)
        batches.append((_split(jtr, 10 + step, num_target=2 + 2 * step), key,
                        _inject(model, key, None)))
    params = jax.tree_util.tree_map(jnp.asarray, jmodel.params)
    opt = optax.adam(LR)
    state = opt.init(params)
    for batch, key, _ in batches:
        _, g = _jax_value_and_grad(jtr, jvae, params, batch, key)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = flatten_params(params)
    tr = _port_trajectory(model, [(b, inj) for b, _, inj in batches])
    assert tr.optimizer.state[tr.params["generation_linear"]["w"]]["step"].item() == 3
    err = max(np.abs(p.detach().numpy() - want[k]).max() for k, p in iter_leaves(tr.params))
    assert err <= ADAM_ATOL, err


def test_process_batch_data_bit_equal_to_jax():
    """Five batches of one seed: the same split, packed the same way."""
    _, jmodel, model = _models()
    jtr = JaxLatentRNNTrainer(DATA, jmodel, seed=3)
    tr = LatentRNNTrainer(DATA, model, device="cpu", seed=3)
    for i in range(5):
        windows = _windows(30 + i)
        want = jtr.process_batch_data((windows,))
        got = tr.process_batch_data((windows,))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert a.dtype == torch.from_numpy(b).dtype
            np.testing.assert_array_equal(a.numpy(), b)


def test_frozen_vae_unchanged_and_latent_rnn_moves():
    """Steps with every dropout on (LatentRNN 0.5, VAE encoder 0.5) on both
    coins: the VAE's parameters are bit-unchanged and take no gradient,
    the LatentRNN's move."""
    _, _, model = _models(auto_reg=True, dropout=0.5, enc_dropout=0.5)
    vae_before = {k: v.clone() for k, v in model.vae_model.state_dict().items()}
    tr = LatentRNNTrainer(DATA, model, lr=LR, device="cpu", seed=2)
    start = [p.detach().clone() for _, p in iter_leaves(tr.params)]
    windows = _windows(7)
    for coin in (True, False):
        loss, _ = tr.train_step(tr.process_batch_data((windows,)), coin=coin)
        assert np.isfinite(loss.item())
    assert all(not p.requires_grad for p in model.vae_model.parameters())
    assert all(not t.requires_grad for _, t in iter_leaves(tr.extra))
    for k, v in model.vae_model.state_dict().items():
        assert torch.equal(v, vae_before[k]), k
    for _, t in iter_leaves(tr.extra):
        assert t.grad is None
    # every leaf with a gradient moved (a one-measure past leaves the
    # context GRUs' w_hh none: h0 is 0 at their only valid step)
    for (k, p), s in zip(iter_leaves(tr.params), start):
        assert p.grad is not None, k
        assert p.grad.abs().max() == 0 or not torch.equal(p.detach(), s), k


@pytest.mark.parametrize("coin", [True, False], ids=["teacher_forced", "sampled"])
def test_dropout_keep_rate_and_scale(monkeypatch, coin):
    """Every dropout site of a training step keeps each element with
    probability 1 - p and scales kept ones by 1 / (1 - p): the frozen
    encoder's (one call over past, future and target, then each re-encode
    on the sampled branch), the context GRUs', and the generation GRU's
    (one pass, or each step of the sampled loop); the decode has none.
    The keep share is held within 4 binomial standard deviations of
    1 - p; a mask drawn with the rate swapped breaks that bound."""
    rate = 0.3
    _, _, model = _models(auto_reg=True, dropout=rate, enc_dropout=rate)
    seen = []
    apply_dropout = gru_mod.apply_dropout

    def spy(x, keep, r):
        out = apply_dropout(x, keep, r)
        seen.append((x, keep, out, r))
        return out

    monkeypatch.setattr(gru_mod, "apply_dropout", spy)
    tr = LatentRNNTrainer(DATA, model, device="cpu")
    with torch.no_grad():
        tr.loss_and_metrics(tr.params, tr.process_batch_data((_windows(8),)), True,
                            extra=tr.extra, coin=coin)
    rows = B * (2 * N_BARS + MT)
    if coin:  # encoder, context past and future, generation
        shapes = [(rows, 24, 2 * H), (B, N_BARS, 2 * H), (B, N_BARS, 2 * H), (B, MT, 4 * H)]
    else:  # then MT generation steps, a re-encode between each two
        shapes = ([(rows, 24, 2 * H), (B, N_BARS, 2 * H), (B, N_BARS, 2 * H)]
                  + [(B, 1, 4 * H), (B, 24, 2 * H)] * (MT - 1) + [(B, 1, 4 * H)])
    assert [tuple(k.shape) for _, k, _, _ in seen] == shapes
    for x, k, out, r in seen:
        assert r == rate
        torch.testing.assert_close(out, torch.where(k, x / (1 - rate), torch.zeros_like(x)))
    keep = torch.cat([k.flatten() for _, k, _, _ in seen]).float()

    def within(share, n):
        return abs(share - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)

    assert within(keep.mean().item(), keep.numel())
    swapped = (torch.rand(keep.shape, generator=torch.Generator().manual_seed(1)) < rate).float()
    assert not within(swapped.mean().item(), keep.numel())


@pytest.mark.parametrize("ablation,auto_reg,tf", [(None, False, True), (None, True, True),
                                                  (None, True, False), ("past", False, True),
                                                  ("future", True, True)])
def test_repr_and_checkpoints_match_jax(tmp_path, ablation, auto_reg, tf):
    """The port's repr (so its checkpoint's name) equals JAX's; a checkpoint
    the port writes loads in the JAX package, and one JAX writes loads in
    the port, exactly."""
    jvae, jmodel, model = _models(ablation, auto_reg)
    jmodel.checkpoint_dir = model.checkpoint_dir = str(tmp_path)
    jmodel.use_teacher_forcing = model.use_teacher_forcing = tf and auto_reg
    assert repr(model) == repr(jmodel) and model.filepath == jmodel.filepath
    model.save()
    jmodel.init(jax.random.PRNGKey(9))
    jmodel.load()
    want = flatten_params(model.params())
    got = flatten_params(jmodel.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jmodel.init(jax.random.PRNGKey(10))
    jmodel.save()
    model.load()
    for k, v in flatten_params(model.params()).items():
        np.testing.assert_array_equal(v, flatten_params(jmodel.params)[k], err_msg=k)


def test_training_route_gate(monkeypatch):
    """The gate is a function of the width alone: every width (the H-1024
    generation GRU, H 16 on zero units, and above 1024, since K5/K6 run on
    tile groups) takes the trainfast Function; an unmasked training layer
    follows it."""
    assert gk.trainfast_supports(512) and gk.trainfast_supports(64)
    assert gk.trainfast_supports(1024) and gk.trainfast_supports(16)
    assert gk.trainfast_supports(1088) and not gk.trainfast_supports(0)
    calls = []
    real = gk.gru_fwd_seq_reference
    monkeypatch.setattr(gk, "gru_fwd_seq_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for hidden, want in ((64, 1), (16, 1), (1088, 1)):
        calls.clear()
        p = {k: torch.from_numpy(v) for k, v in
             gru_mod.gru_init(np.random.default_rng(0), 3, hidden, 1)[0][0].items()}
        gru_mod.gru_layer_apply(p, torch.zeros((2, 4, 3)), torch.zeros((2, hidden)), train=True)
        assert len(calls) == want, hidden


def test_frozen_encoder_takes_k5_and_never_k6(monkeypatch):
    """At a width K5/K6 take (64): a non-autoregressive training step runs
    the frozen encoder through the trainfast forward (4 layer-directions,
    one encode) and never its backward, which nothing upstream needs."""
    from inpaintnet_tpu_torch.models.presets import build_flagship

    _, _, model = build_flagship(vocab_size=V, hidden=64, z_dim=Z, emb=E, seed=0,
                                 device="cpu", dataset=DATA)
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = gk.gru_fwd_seq_reference, gk.gru_bwd_seq_reference
    monkeypatch.setattr(gk, "gru_fwd_seq_reference",
                        lambda *a, **k: counts.__setitem__("fwd", counts["fwd"] + 1) or fwd(*a, **k))
    monkeypatch.setattr(gk, "gru_bwd_seq_reference",
                        lambda *a, **k: counts.__setitem__("bwd", counts["bwd"] + 1) or bwd(*a, **k))
    tr = LatentRNNTrainer(DATA, model, device="cpu")
    loss, _ = tr.train_step(tr.process_batch_data((_windows(9),)))
    assert np.isfinite(loss.item())
    assert counts == {"fwd": 4, "bwd": 0}


# --------------------------------------------------------------------------- #
# train_model on the JAX package's synthetic FolkDatasetNBars
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def folk(tmp_path_factory):
    corpus = tmp_path_factory.mktemp("corpus")
    cache = tmp_path_factory.mktemp("cache")
    generate_corpus(str(corpus), num_tunes=2, num_bars=16, seed=1)
    mgr = DatasetManager(cache_dir=str(cache), corpus_dir=str(corpus))
    ds = mgr.get_dataset("folk_4by4nbars_short", metadatas=[BeatMarkerMetadata(6),
                                                            TickMetadata(6)],
                         num_bars=N_BARS, train=True)
    return ds, ArrayDataset(ds.arrays, N_BARS)


def test_train_model_learns_saves_and_resumes(folk, monkeypatch, tmp_path):
    """``train_model`` on an ``ArrayDataset`` over the synthetic corpus:
    the validation loss falls over 2 epochs; the model checkpoint exists
    under its name and loads back exactly; a fresh trainer's
    ``load_state`` restores the parameters, the Adam state and the epoch
    count exactly."""
    ds, data = folk
    monkeypatch.chdir(tmp_path)

    def fresh(seed):
        vae = MeasureVAE(ds, note_embedding_dim=E, encoder_hidden_size=H, latent_space_dim=Z,
                         decoder_hidden_size=H, device="cpu", seed=0)
        return tlr.LatentRNN(vae, 2, H, device="cpu", dataset=ds,
                             checkpoint_dir=str(tmp_path / "ckpt"), seed=seed)

    model = fresh(0)
    trainer = LatentRNNTrainer(data, model, lr=3e-3, device="cpu", seed=1)
    _, val, _ = data.data_loaders(batch_size=16, split=(0.7, 0.2))
    l0, _ = trainer.loss_and_acc_on_epoch(val, train=False)
    trainer.train_model(batch_size=16, num_epochs=2, split=(0.7, 0.2), run_name="latent")
    l1, a1 = trainer.loss_and_acc_on_epoch(val, train=False)
    assert np.isfinite(l1) and l1 < l0 and 0.0 <= a1 <= 1.0
    assert trainer.epoch == 2
    assert len((tmp_path / "runs" / "latent.jsonl").read_text().splitlines()) == 2
    other = fresh(1).load()
    for (k, p), (_, q) in zip(iter_leaves(other.params()), iter_leaves(trainer.params)):
        assert torch.equal(p, q.detach()), k
    resumed = LatentRNNTrainer(data, fresh(2), lr=3e-3, device="cpu")
    assert resumed.load_state() == 2 and resumed.epoch == 2
    for (k, p), (_, q) in zip(iter_leaves(resumed.params), iter_leaves(trainer.params)):
        assert torch.equal(p, q), k
        s, t = resumed.optimizer.state[p], trainer.optimizer.state[q]
        assert set(s) == set(t) == {"step", "exp_avg", "exp_avg_sq"}
        for name in s:
            assert torch.equal(s[name], t[name]), (k, name)
