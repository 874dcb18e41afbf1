"""AnticipationRNN training in the port against the JAX package, on the CPU.

The JAX side runs the package's own trainers (``AnticipationRNNGaussianReg
Trainer`` and ``AnticipationRNNBaselineTrainer``: their constraint masks and
``loss_and_metrics`` over ``apply(train=True)`` or, with the gaussian term,
``forward_tf``); the port's side runs ``inpaintnet_tpu_torch.train``'s.
Small size: vocab 30, note embedding 6, metadata embedding 3, 2-layer LSTMs
of 16, linear 12, unary constraints, 9 bars of 6 ticks, batch 4, jittered
weights. JAX's teacher-forcing coin and every dropout keep mask of its step
key are injected into the port (``_jax_masks`` replays the key splits).

Bounds, each with its reason, and the planted faults they must reject:

- loss: 2e-5 absolute (``docs/PARITY.md`` §2); f32 on both sides;
- gradients: 2e-5 absolute; f32 sums in another order through two LSTM
  stacks and an argmax loop;
- a 3-step Adam trajectory against optax at lr 1e-3: parameters within
  2e-6, a few f32 ulps of parameters below 4; the first Adam step moves
  every element by about lr whatever the gradient's size, so the bound
  holds each update's sign and size as well;
- planted faults, each rejected by the loss or the gradients: the
  constraint stack's dropout mask applied in forward time (not flipped with
  the sequence), and the teacher-forced pass fed the START embedding at
  tick 0 instead of zeros; the gaussian term alone, against JAX's at few
  rows, where variances without Bessel's correction break the bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inpaintnet_tpu.models.anticipation_rnn import AnticipationRNNBaseline as JaxBaseline
from inpaintnet_tpu.models.anticipation_rnn import ConstraintModelGaussianReg as JaxReg
from inpaintnet_tpu.train.arnn_trainer import (
    AnticipationRNNBaselineTrainer as JaxBaselineTrainer,
    AnticipationRNNGaussianRegTrainer as JaxRegTrainer,
)
from inpaintnet_tpu_torch.data import (
    BeatMarkerMetadata,
    DatasetManager,
    TickMetadata,
)
from inpaintnet_tpu_torch.data.synthetic import generate_corpus
from inpaintnet_tpu_torch.models import anticipation_rnn as tarnn
from inpaintnet_tpu_torch.models.anticipation_rnn import (
    AnticipationRNNBaseline,
    ConstraintModelGaussianReg,
)
from inpaintnet_tpu_torch.models.base import flatten_params, iter_leaves
from inpaintnet_tpu_torch.ops import lstm as tlstm
from inpaintnet_tpu_torch.train import (
    AnticipationRNNBaselineTrainer,
    AnticipationRNNGaussianRegTrainer,
)
from inpaintnet_tpu_torch.train.data import ArrayDataset

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

V, N_BARS, B = 30, 9, 4
SUBDIVISION, BEATS = 6, 1  # 6-tick measures keep the sequences short
T = N_BARS * SUBDIVISION * BEATS
MD_VALUES = (4, 6)  # beat marker, tick; the voice channel is appended
LOSS_ATOL = 2e-5
GRAD_ATOL = 2e-5
ADAM_ATOL = 2e-6
LR = 1e-3
TRAINERS = {"reg": (JaxReg, JaxRegTrainer, ConstraintModelGaussianReg,
                    AnticipationRNNGaussianRegTrainer),
            "baseline": (JaxBaseline, JaxBaselineTrainer, AnticipationRNNBaseline,
                         AnticipationRNNBaselineTrainer)}


class _Metadata:
    def __init__(self, name, num_values):
        self.name, self.num_values = name, num_values


class Windows(ArrayDataset):
    """In-memory windows with the vocabulary, metadata channels and measure
    geometry the JAX package's models and trainers read."""

    subdivision = SUBDIVISION
    num_beats_per_bar = BEATS
    num_voices = 1

    def __init__(self, arrays, n_bars: int = N_BARS):
        super().__init__(arrays, n_bars)
        self.note2index_dicts = [{f"N{i}": i for i in range(V - 1)} | {"START": V - 1}]
        self.metadatas = [_Metadata(n, v) for n, v in zip(("beatmarker", "tick"), MD_VALUES)]

    def __repr__(self):
        return f"Windows({self.n_bars},{V})"


def _windows(seed, n=B):
    rng = np.random.default_rng(seed)
    score = rng.integers(0, V, (n, 1, T)).astype(np.int32)
    md = np.stack([rng.integers(0, v, (n, 1, T)) for v in MD_VALUES]
                  + [np.zeros((n, 1, T), np.int64)], axis=-1).astype(np.int32)
    return score, md


DATA = Windows(_windows(0, 16))


def _models(kind="reg", dropout=0.2, tf=True, hidden=16, seed=0):
    """The JAX model (jittered parameters: zero biases would hide bias bugs)
    and the port's holding the same parameters."""
    jax_cls, _, port_cls, _ = TRAINERS[kind]
    kw = dict(note_embedding_dim=6, metadata_embedding_dim=3,
              num_lstm_constraints_units=hidden, num_lstm_generation_units=hidden,
              linear_hidden_size=12, num_layers=2, dropout_input_prob=dropout,
              dropout_prob=dropout, unary_constraint=True, teacher_forcing=tf)
    jmodel = jax_cls(DATA, **kw)
    jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jmodel.params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jmodel.params)
    model = port_cls(DATA, device="cpu", **kw)
    model.set_params(jmodel.params)
    return jmodel, model


def _coin_key(want, start=0):
    """A step key whose teacher-forcing coin (``split(key)[0]``) is ``want``."""
    for seed in range(start, start + 100):
        key = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(jax.random.split(key)[0], 0.5)) == want:
            return key
    raise AssertionError("no key gives that coin")


def _stack_masks(key, rate, hidden, rows=B):
    """One keep mask a non-last layer of a 2-layer stack (``rng, sub =
    split(rng)``), over (rows, T, H) as the stack saw it."""
    _, sub = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.bernoulli(sub, 1.0 - rate,
                                                           (rows, T, hidden))))]


def _jax_masks(key, model, reg: bool, coin, rows=B):
    """The keep masks JAX's loss draws from step key ``key`` over a batch of
    ``rows``: ``apply`` splits ``r_flip, r_fwd``; the gaussian term calls
    ``forward_tf`` on the key itself; ``forward_tf`` splits ``r_c, r_g,
    r_in`` and ``forward_sampled`` ``r_c, r_scan``."""
    rate, hidden = model.dropout_prob, model.num_lstm_generation_units
    fwd = key if reg else jax.random.split(key)[1]
    teacher_forced = reg or (model.use_teacher_forcing and coin)
    if not teacher_forced:
        return {"constraint": _stack_masks(jax.random.split(fwd)[0], rate, hidden, rows)}
    r_c, r_g, r_in = jax.random.split(fwd, 3)
    keep_in = jax.random.bernoulli(r_in, 1.0 - model.dropout_input_prob, (rows, T, 1))
    return {"constraint": _stack_masks(r_c, rate, hidden, rows),
            "generation": _stack_masks(r_g, rate, hidden, rows),
            "input": torch.from_numpy(np.array(keep_in))}


def _jax_trainer(kind, jmodel, reg=0.0, seed=0):
    return TRAINERS[kind][1](DATA, jmodel, lr=LR, seed=seed, gaussian_reg_coeff=reg)


def _port_trainer(kind, model, reg=0.0, seed=0):
    return TRAINERS[kind][3](DATA, model, lr=LR, seed=seed, gaussian_reg_coeff=reg,
                             device="cpu")


def _jax_value_and_grad(jtr, params, batch, key):
    """The JAX trainer's training loss and its gradient, one compile a
    trainer."""
    if not hasattr(jtr, "test_value_and_grad"):
        jtr.test_value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, b, k: jtr.loss_and_metrics(p, b, k, True)[0]))
    return jtr.test_value_and_grad(jax.tree_util.tree_map(jnp.asarray, params), batch, key)


def _tensors(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)


def _port_value_and_grad(tr, batch, inject):
    tr.optimizer.zero_grad(set_to_none=True)
    loss, _ = tr.loss_and_metrics(tr.params, _tensors(batch), True, **inject)
    loss.backward()
    return loss.item(), {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
                         for k, p in iter_leaves(tr.params)}


def _grad_err(got, want):
    return max(np.abs(got[k] - want[k]).max() for k in want)


# (trainer, dropout, teacher forcing, gaussian_reg_coeff, coin): both trainers
# on both coins, the sampled branch alone, and the gaussian term
CASES = {
    "reg_heads": ("reg", 0.2, True, 0.0, True),
    "reg_tails": ("reg", 0.2, True, 0.0, False),
    "baseline_heads": ("baseline", 0.5, True, 0.0, True),
    "baseline_tails": ("baseline", 0.5, True, 0.0, False),
    "baseline_no_tf": ("baseline", 0.2, False, 0.0, None),
    "reg_gaussian": ("reg", 0.5, True, 0.1, None),
    "baseline_gaussian": ("baseline", 0.2, True, 0.1, None),
}
_COMPILED = {}


def _case(name):
    """Models, trainers and JAX's compiled step, shared by the cases of one
    (trainer, dropout, teacher forcing, coefficient)."""
    kind, dropout, tf, reg, coin = CASES[name]
    if (kind, dropout, tf, reg) not in _COMPILED:
        jmodel, model = _models(kind, dropout, tf)
        _COMPILED[kind, dropout, tf, reg] = (jmodel, model, _jax_trainer(kind, jmodel, reg),
                                             _port_trainer(kind, model, reg))
    return (coin, reg > 0) + _COMPILED[kind, dropout, tf, reg]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(name, monkeypatch):
    coin, reg, jmodel, model, jtr, tr = _case(name)
    key = jax.random.PRNGKey(5) if coin is None else _coin_key(coin)
    batch = jtr.process_batch_data(_windows(1))
    v, g = _jax_value_and_grad(jtr, jmodel.params, batch, key)
    want = flatten_params(g)
    inject = {"coin": coin, "masks": _jax_masks(key, model, reg, coin)}
    got_v, got = _port_value_and_grad(tr, batch, inject)
    assert set(got) == set(want)
    np.testing.assert_allclose(got_v, float(v), rtol=0, atol=LOSS_ATOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_ATOL, err_msg=k)
    # the gradients stand well above the bound
    assert max(np.abs(w).max() for w in want.values()) > 50 * GRAD_ATOL

    # planted faults, one at a time
    masks = inject["masks"]
    forward = {**masks, "constraint": [m.flip(1) for m in masks["constraint"]]}
    v_f, g_f = _port_value_and_grad(tr, batch, {**inject, "masks": forward})
    assert abs(v_f - float(v)) > LOSS_ATOL or _grad_err(g_f, want) > GRAD_ATOL
    if "generation" in masks:
        start = model._start_embedding(tr.params, B)[:, None]
        with monkeypatch.context() as m:
            m.setattr(tarnn, "shift_right",
                      lambda x: torch.cat([start.to(x.dtype), x[:, :-1]], dim=1))
            v_f, g_f = _port_value_and_grad(tr, batch, inject)
            assert abs(v_f - float(v)) > LOSS_ATOL or _grad_err(g_f, want) > GRAD_ATOL


def test_gaussian_regularization_matches_jax():
    """The activation term over three layers of 6 rows (B 2 x T 3), where
    Bessel's correction moves each variance by a fifth: within 1e-5 of
    JAX's (f32 sums in another order); variances without it break that."""
    rng = np.random.default_rng(4)
    acts = [rng.standard_normal((2, 3, h)).astype(np.float32) for h in (8, 8, 5)]
    want = float(JaxRegTrainer.gaussian_regularization([jnp.asarray(a) for a in acts]))
    got = AnticipationRNNGaussianRegTrainer.gaussian_regularization(
        [torch.from_numpy(a) for a in acts]).item()
    assert abs(got - want) <= 1e-5 * abs(want)
    biased = sum((a.reshape(-1, a.shape[-1]).mean(0) ** 2).sum()
                 + ((v - v.mean()) ** 2).sum()
                 for a in acts for v in [a.reshape(-1, a.shape[-1]).var(0)])
    assert abs(biased - want) > 1e-5 * abs(want)


def test_adam_trajectory_matches_optax():
    """Three Adam steps of the baseline trainer with dropout 0.2 against
    optax.adam on the same losses (coins heads, tails, heads): the
    parameters after the third step."""
    jmodel, model = _models("baseline", 0.2, True, seed=3)
    jtr = _jax_trainer("baseline", jmodel)
    steps = []
    for step, coin in enumerate((True, False, True)):
        key = _coin_key(coin, start=20 * step)
        steps.append((jtr.process_batch_data(_windows(10 + step)), key,
                      {"coin": coin, "masks": _jax_masks(key, model, False, coin)}))
    params = jax.tree_util.tree_map(jnp.asarray, jmodel.params)
    opt = optax.adam(LR)
    state = opt.init(params)
    for batch, key, _ in steps:
        _, g = _jax_value_and_grad(jtr, params, batch, key)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = flatten_params(params)
    tr = _port_trainer("baseline", model)
    for batch, _, inject in steps:
        tr.train_step(_tensors(batch), **inject)
    assert tr.optimizer.state[tr.params["linear_1"]["w"]]["step"].item() == 3
    err = max(np.abs(p.detach().numpy() - want[k]).max() for k, p in iter_leaves(tr.params))
    assert err <= ADAM_ATOL, err


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_process_batch_data_bit_equal_to_jax(kind):
    """A train pass then a validation pass over the loaders, one draw stream:
    the same constraint masks and arrays, batch by batch."""
    jmodel, model = _models(kind)
    jtr = TRAINERS[kind][1](DATA, jmodel, seed=3)
    tr = TRAINERS[kind][3](DATA, model, device="cpu", seed=3)
    train, val, _ = DATA.data_loaders(batch_size=4, split=(0.5, 0.3))
    batches = list(train) + list(val)
    assert len(batches) == 3  # two train batches, one validation batch
    for batch in batches:
        want = jtr.process_batch_data(batch)
        got = tr.process_batch_data(batch)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == torch.int32 and b.dtype == np.int32
            np.testing.assert_array_equal(a.numpy(), b)
    if kind == "reg":  # the span: num_target, then num_past, start at num_past + 1
        rs = np.random.RandomState(3 + 29)
        jtr2 = TRAINERS[kind][1](DATA, jmodel, seed=3)
        loc, start, end, past, target = jtr2.get_constraints_location(_windows(2)[0], True)
        assert (target, past) == (rs.randint(2, 7), rs.randint(1, N_BARS - target - 1))
        assert start == (past + 1) * SUBDIVISION * BEATS


def test_n_bars_and_measure_length():
    """Fewer than 9 bars is refused; the measure length is the dataset's
    ``subdivision * num_beats_per_bar``, else 24."""
    _, model = _models()
    with pytest.raises(ValueError, match="too small"):
        AnticipationRNNGaussianRegTrainer(Windows(DATA.arrays, n_bars=8), model, device="cpu")
    tr = AnticipationRNNBaselineTrainer(DATA, model, device="cpu")
    assert tr.measure_seq_len == SUBDIVISION * BEATS
    plain = ArrayDataset(DATA.arrays, N_BARS)
    assert AnticipationRNNBaselineTrainer(plain, model, device="cpu").measure_seq_len == 24


@pytest.mark.parametrize("coin", [True, False], ids=["teacher_forced", "sampled"])
def test_dropout_keep_rate_and_scale(monkeypatch, coin):
    """Every dropout site of a training step keeps each element with
    probability 1 - p and scales kept ones by 1 / (1 - p): the constraint
    stack's first layer, and on the teacher-forced branch the generation
    stack's and the input's whole ticks. The keep share is held within 4
    binomial standard deviations of 1 - p; a mask drawn with the rate
    swapped breaks that bound."""
    rate = 0.3
    _, model = _models("baseline", rate, True)
    seen = []
    apply_dropout = tlstm.apply_dropout

    def spy(x, keep, r):
        out = apply_dropout(x, keep, r)
        seen.append((x, keep, out, r))
        return out

    monkeypatch.setattr(tlstm, "apply_dropout", spy)
    monkeypatch.setattr(tarnn, "apply_dropout", spy)
    tr = _port_trainer("baseline", model)
    with torch.no_grad():
        tr.loss_and_metrics(tr.params, tr.process_batch_data(_windows(8)), True, coin=coin)
    shapes = [(B, T, 16), (B, T, 1), (B, T, 16)] if coin else [(B, T, 16)]
    assert [tuple(k.shape) for _, k, _, _ in seen] == shapes
    for x, k, out, r in seen:
        assert r == rate
        torch.testing.assert_close(out, torch.where(k, x / (1 - rate), torch.zeros_like(x)))
    keep = torch.cat([k.expand_as(x).flatten() for x, k, _, _ in seen]).float()

    def within(share, n):
        return abs(share - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)

    assert within(keep.mean().item(), keep.numel())
    swapped = (torch.rand(keep.shape, generator=torch.Generator().manual_seed(1)) < rate).float()
    assert not within(swapped.mean().item(), keep.numel())


@pytest.mark.parametrize("kind,tf", [("reg", True), ("baseline", True), ("baseline", False)])
def test_repr_and_checkpoints_match_jax(tmp_path, kind, tf):
    """The port's repr (so its checkpoint's name) equals JAX's; a checkpoint
    the port writes loads in the JAX package, and one JAX writes loads in
    the port, exactly."""
    jmodel, model = _models(kind, 0.2, tf)
    jmodel.checkpoint_dir = model.checkpoint_dir = str(tmp_path)
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


@pytest.mark.parametrize("kind,tf", [("reg", True), ("baseline", True), ("baseline", False)])
def test_k7_route_in_validation_never_in_training(monkeypatch, kind, tf):
    """At a width K7 takes (64): every validation batch calls K7's wrapper
    once (its plain version here, on the CPU), no train step does, on
    either coin."""
    _, model = _models(kind, 0.2, tf, hidden=64)
    calls = []
    real = tarnn.arnn_sampled_decode
    monkeypatch.setattr(tarnn, "arnn_sampled_decode",
                        lambda *a: calls.append(1) or real(*a))
    tr = _port_trainer(kind, model)
    batch = tr.process_batch_data(_windows(4))
    for coin in (True, False):
        loss, _ = tr.train_step(batch, coin=coin)
        assert np.isfinite(loss.item()) and not calls
    _, val, _ = DATA.data_loaders(batch_size=4, split=(0.5, 0.3))
    for i, b in enumerate(val):
        loss, _ = tr.eval_step(tr.process_batch_data(b))
        assert np.isfinite(loss.item()) and len(calls) == i + 1


# --------------------------------------------------------------------------- #
# train_model on the port's own FolkDatasetNBars
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def folk(tmp_path_factory):
    corpus = tmp_path_factory.mktemp("corpus")
    cache = tmp_path_factory.mktemp("cache")
    generate_corpus(str(corpus), num_tunes=3, num_bars=16, seed=1)
    mgr = DatasetManager(cache_dir=str(cache), corpus_dir=str(corpus))
    return mgr.get_dataset("folk_4by4nbars_short", metadatas=[BeatMarkerMetadata(6),
                                                              TickMetadata(6)],
                           num_bars=N_BARS, train=True)


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_train_model_learns_saves_and_resumes(folk, monkeypatch, tmp_path, kind):
    """``train_model`` on the port's ``FolkDatasetNBars`` over the synthetic
    corpus: the validation loss falls over 2 epochs; the model checkpoint
    exists under its name and loads back exactly; a fresh trainer's
    ``load_state`` restores the parameters, the Adam state and the epoch
    count exactly."""
    monkeypatch.chdir(tmp_path)
    cls = TRAINERS[kind][2]

    def fresh(seed):
        return cls(folk, note_embedding_dim=6, metadata_embedding_dim=3,
                   num_lstm_constraints_units=16, num_lstm_generation_units=16,
                   linear_hidden_size=16, num_layers=2, dropout_prob=0.2, dropout_input_prob=0.2,
                   unary_constraint=True, checkpoint_dir=str(tmp_path / "ckpt"), device="cpu",
                   seed=seed)

    trainer = TRAINERS[kind][3](folk, fresh(0), lr=1e-2, device="cpu", seed=1)
    _, val, _ = folk.data_loaders(batch_size=8, split=(0.7, 0.2))
    probe = AnticipationRNNBaselineTrainer(folk, fresh(0), device="cpu", seed=7)
    batches = [probe.process_batch_data(b) for b in val]

    def val_loss():
        return np.mean([trainer.eval_step(b)[0].item() for b in batches])

    l0 = val_loss()
    trainer.train_model(batch_size=8, num_epochs=2, split=(0.7, 0.2), run_name="arnn")
    l1 = val_loss()
    assert np.isfinite(l1) and l1 < l0
    assert trainer.epoch == 2
    assert len((tmp_path / "runs" / "arnn.jsonl").read_text().splitlines()) == 2
    other = fresh(1).load()
    for (k, p), (_, q) in zip(iter_leaves(other.params()), iter_leaves(trainer.params)):
        assert torch.equal(p, q.detach()), k
    resumed = TRAINERS[kind][3](folk, fresh(2), lr=1e-2, device="cpu")
    assert resumed.load_state() == 2 and resumed.epoch == 2
    for (k, p), (_, q) in zip(iter_leaves(resumed.params), iter_leaves(trainer.params)):
        assert torch.equal(p, q), k
        s, t = resumed.optimizer.state[p], trainer.optimizer.state[q]
        assert set(s) == set(t) == {"step", "exp_avg", "exp_avg_sq"}
        for name in s:
            assert torch.equal(s[name], t[name]), (k, name)
