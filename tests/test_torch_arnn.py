"""The port's AnticipationRNN pieces against the JAX package on the CPU: the
LSTM ops, the metadata channels, the sampling, K7's plain version against
the JAX kernel (interpret mode), the model's decodes, and the parameter
conversion and checkpoints. The same weights (the JAX model's) and the same
inputs (numpy, from a seed) go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.data.metadata import BeatMarkerMetadata as JaxBeatMarker
from inpaintnet_tpu.data.metadata import TickMetadata as JaxTick
from inpaintnet_tpu.models.anticipation_rnn import AnticipationRNNBaseline as JaxARNN
from inpaintnet_tpu.models.anticipation_rnn import ConstraintModelGaussianReg as JaxCMGR
from inpaintnet_tpu.models.base import cast_pytree
from inpaintnet_tpu.models.torch_port import export_anticipation_rnn
from inpaintnet_tpu.ops import lstm as jax_lstm
from inpaintnet_tpu.ops.arnn_pallas import arnn_sampled_decode_pallas
from inpaintnet_tpu_torch.data.metadata import BeatMarkerMetadata, TickMetadata
from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
from inpaintnet_tpu_torch.models.convert import (
    anticipation_rnn_from_jax_params,
    anticipation_rnn_leaves,
    to_functional,
)
from inpaintnet_tpu_torch.models.presets import ARNNDataset, build_arnn
from inpaintnet_tpu_torch.ops import arnn_kernel, lstm
from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_kernel_supports, arnn_sampled_decode
from inpaintnet_tpu_torch.ops.sampling import row_gumbel, sample_categorical

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

V = 30


class JaxDS:
    note2index_dicts = [{f"t{i}": i for i in range(V)}]
    metadatas = [JaxBeatMarker(), JaxTick()]
    num_voices = 1

    def __repr__(self):
        return "ds"


class PortDS(JaxDS):
    metadatas = [BeatMarkerMetadata(), TickMetadata()]


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _tensors(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype),
                                  _np(tree))


def make_pair(hidden: int, seed: int = 0):
    """A JAX model and the port's model holding its weights (linear hidden
    12: the kernel pads the head; hidden 64 opens the port's K7 gate)."""
    kw = dict(note_embedding_dim=8, metadata_embedding_dim=4, num_lstm_constraints_units=hidden,
              num_lstm_generation_units=hidden, linear_hidden_size=12, num_layers=2,
              unary_constraint=True)
    jm = JaxARNN(JaxDS(), **kw)
    jm.init(jax.random.PRNGKey(seed))
    pm = AnticipationRNNBaseline(PortDS(), device="meta", **kw)
    pm.to_empty(device="cpu")
    pm.load_state_dict(anticipation_rnn_from_jax_params(_np(jm.params)), strict=True)
    return jm, pm


def make_batch(batch: int, seq_len: int, seed: int = 0, span=(30, 60)):
    rs = np.random.RandomState(seed)
    score = rs.randint(0, V, (batch, seq_len)).astype(np.int32)
    md = np.stack([JaxBeatMarker().generate(seq_len), JaxTick().generate(seq_len),
                   np.zeros(seq_len, np.int64)], axis=-1)[None].repeat(batch, 0).astype(np.int32)
    loc = np.ones((batch, seq_len), np.int32)
    loc[:, span[0]:span[1]] = 0
    return score, md, loc


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------- #
# ops
# --------------------------------------------------------------------------- #
def _lstm_case(seed=0, batch=4, seq_len=12, in_dim=7, hidden=16, layers=2):
    params = jax_lstm.lstm_stack_init(jax.random.PRNGKey(seed),
                                      [(in_dim, hidden)] + [(hidden, hidden)] * (layers - 1))
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((batch, seq_len, in_dim)).astype(np.float32)
    h0 = (0.5 * rs.standard_normal((layers, batch, hidden))).astype(np.float32)
    c0 = (0.5 * rs.standard_normal((layers, batch, hidden))).astype(np.float32)
    lengths = np.array([seq_len, 5, 1, 9])[:batch]
    mask = (np.arange(seq_len)[None] < lengths[:, None]).astype(np.int32)
    return params, x, h0, c0, mask


# f32 on both sides, the same gate formulas; the sums' order may differ
LSTM_ATOL = 1e-6


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm_layer_matches_jax(reverse, masked):
    params, x, h0, c0, mask = _lstm_case()
    m = mask if masked else None
    ys_j, (h_j, c_j) = jax_lstm.lstm_layer_apply(
        params[0], jnp.asarray(x), jnp.asarray(h0[0]), jnp.asarray(c0[0]), reverse=reverse,
        mask=None if m is None else jnp.asarray(m))
    ys, (h, c) = lstm.lstm_layer_apply(_tensors(params[0]), *_t(x, h0[0], c0[0]),
                                       reverse=reverse,
                                       mask=None if m is None else torch.from_numpy(m))
    for got, want in ((ys, ys_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LSTM_ATOL, rtol=0)
    if masked and not reverse:
        # a row's masked suffix holds its last valid state and emits it
        np.testing.assert_array_equal(ys[1, 5:].numpy(), np.repeat(ys[1, 4:5].numpy(), 7, 0))


@pytest.mark.parametrize("masked", [False, True])
def test_lstm_stack_matches_jax(masked):
    params, x, h0, c0, mask = _lstm_case(seed=3)
    m = mask if masked else None
    out_j, (hn_j, cn_j), hs_j = jax_lstm.lstm_stack_apply(
        params, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
        mask=None if m is None else jnp.asarray(m))
    out, (hn, cn), hs = lstm.lstm_stack_apply(
        _tensors(params), *_t(x), (torch.from_numpy(h0), torch.from_numpy(c0)),
        mask=None if m is None else torch.from_numpy(m))
    assert len(hs) == len(hs_j) == 2
    for got, want in ((out, out_j), (hn, hn_j), (cn, cn_j), (hs[0], hs_j[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LSTM_ATOL, rtol=0)
    # training: JAX's inter-layer dropout mask (``rng, sub = split(rng)``)
    # given to the port
    key = jax.random.PRNGKey(4)
    out_j, _, hs_j = jax_lstm.lstm_stack_apply(params, jnp.asarray(x), dropout=0.3, rng=key,
                                               train=True, mask=None if m is None
                                               else jnp.asarray(m))
    keep = np.array(jax.random.bernoulli(jax.random.split(key)[1], 0.7, hs_j[0].shape))
    out, _, hs = lstm.lstm_stack_apply(_tensors(params), *_t(x), train=True, dropout=0.3,
                                       dropout_masks=[torch.from_numpy(keep)],
                                       mask=None if m is None else torch.from_numpy(m))
    assert not keep.all()
    for got, want in ((out, out_j), (hs[0], hs_j[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LSTM_ATOL, rtol=0)


@pytest.mark.parametrize("length", [1, 47, 384])
def test_metadata_generate_matches_jax(length):
    for mine, theirs in ((BeatMarkerMetadata(), JaxBeatMarker()), (TickMetadata(), JaxTick())):
        assert (mine.name, mine.num_values) == (theirs.name, theirs.num_values)
        np.testing.assert_array_equal(mine.generate(length), theirs.generate(length))
    assert BeatMarkerMetadata().beat_symbol2index_dicts == JaxBeatMarker().beat_symbol2index_dicts


def test_sample_categorical_is_jax_categorical_on_its_noise():
    """``jax.random.categorical(key, l)`` is argmax(gumbel(key) + l): the port
    given JAX's noise draws the same tokens."""
    key = jax.random.PRNGKey(4)
    logits = np.random.RandomState(4).standard_normal((64, V)).astype(np.float32)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), axis=-1))
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = sample_categorical(torch.from_numpy(logits), torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_gumbel_depends_on_the_row_key_alone():
    keys = torch.from_numpy(np.random.RandomState(0).randint(0, 2**32, (5, 2), dtype=np.int64))
    g = row_gumbel(keys, 7, V)
    assert g.shape == (5, 7, V) and bool(torch.isfinite(g).all())
    torch.testing.assert_close(row_gumbel(keys[[3, 1]], 7, V), g[[3, 1]], rtol=0, atol=0)
    # the first ticks of a longer stream are the shorter stream
    torch.testing.assert_close(row_gumbel(keys, 9, V)[:, :7], g, rtol=0, atol=0)
    # standard Gumbel: mean 0.5772, variance pi^2 / 6 (loose: 10,500 draws)
    big = row_gumbel(keys, 70, V)
    assert abs(big.mean().item() - 0.5772) < 0.05 and abs(big.var().item() - 1.6449) < 0.15


# --------------------------------------------------------------------------- #
# K7's plain version against the JAX kernel in interpret mode
# --------------------------------------------------------------------------- #
def _k7_case(jm, batch, seq_len, dtype_j, seed=0):
    p = cast_pytree(jm.params, dtype_j)
    rs = np.random.RandomState(seed)
    hidden = jm.num_lstm_constraints_units
    ctx = (0.5 * rs.standard_normal((batch, seq_len, hidden))).astype(np.float32)
    score = rs.randint(0, V, (batch, seq_len)).astype(np.int32)
    fm = np.ones((batch, seq_len), np.int32)
    fm[:, seq_len // 3: 2 * seq_len // 3] = 0
    ctx_j = jnp.asarray(ctx, dtype_j)
    start = p["note_embedding"]["table"][:1]
    logits, tokens = arnn_sampled_decode_pallas(p, ctx_j, jnp.asarray(score), jnp.asarray(fm),
                                                start, tile_b=8, interpret=True)
    tdt = torch.bfloat16 if dtype_j == jnp.bfloat16 else torch.float32
    port = (_tensors(p, tdt), torch.from_numpy(np.array(ctx_j.astype(jnp.float32))).to(tdt),
            *_t(score, fm), torch.from_numpy(np.array(start.astype(jnp.float32))).to(tdt))
    return port, np.asarray(logits.astype(jnp.float32)), np.asarray(tokens)


@pytest.fixture(scope="module")
def pair64():
    return make_pair(64)


@pytest.mark.parametrize("batch", [3, 11])  # 11 pads the JAX kernel's 8-row tile
def test_plain_k7_matches_jax_kernel_f32(pair64, batch):
    """f32: tokens equal; logits within 1e-5 (both accumulate in f32, in
    other orders: seen 4e-8)."""
    port, lg_j, tok_j = _k7_case(pair64[0], batch, 96, jnp.float32, seed=batch)
    before = arnn_sampled_decode.launches
    lg, tok = arnn_sampled_decode(*port)  # CPU tensors: the plain version
    assert arnn_sampled_decode.launches == before
    assert lg.shape == (batch, 96, V) and tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), tok_j)
    np.testing.assert_allclose(lg.numpy(), lg_j, atol=1e-5, rtol=0)


# bf16 against the JAX kernel (``arnn_kernel.decode_agreement``). Both round
# every carry and the logits to bf16 from f32 sums taken in other orders, so
# a logit's last bit may flip: seen over four seeds at H 64, T 96, 11 rows:
# tokens equal, logits max 2.4e-4 to 4.9e-4 (one ulp), mean 7e-7 to
# 1.5e-6, no logit changed in the first 8 ticks. A c carry kept in f32 (the
# kernel rounds it to bf16 every tick) changes 49-52% of the logits of the
# first 8 ticks; a force mask read one tick late feeds a sampled token
# where the ground truth belongs (tokens 96-97% equal, the first mismatch no
# near-tie).
K7_BF16 = {"tokens": 1.0, "max": 4e-3, "mean": 1e-5, "early": 0.15}


def _k7_bf16_agreement(port, want):
    got = arnn_kernel.arnn_sampled_decode_reference(*port)
    return arnn_kernel.decode_agreement(got, want, port[3])


def test_plain_k7_matches_jax_kernel_bf16_and_rejects_planted_faults(pair64, monkeypatch):
    port, lg_j, tok_j = _k7_case(pair64[0], 11, 96, jnp.bfloat16, seed=0)
    want = (torch.from_numpy(lg_j), torch.from_numpy(tok_j))
    agree = _k7_bf16_agreement(port, want)
    assert arnn_kernel.within(agree, K7_BF16), agree
    monkeypatch.setattr(arnn_kernel, "carry_c", lambda c, dtype: c)
    agree = _k7_bf16_agreement(port, want)
    assert agree["early_changed"] > K7_BF16["early"], agree
    monkeypatch.undo()
    fm = port[3]
    late = torch.cat([fm[:, :1], fm[:, :-1]], dim=1)
    agree = arnn_kernel.decode_agreement(
        arnn_kernel.arnn_sampled_decode_reference(*port[:3], late, port[4]), want, fm)
    assert not arnn_kernel.within(agree, K7_BF16), agree


# K7's bf16 route takes the context product of every tick first, in f32
# (``arnn_sampled_decode_staged_reference``). Against the plain version on
# the CPU that is the same function: seen bit-equal at H 64, T 96 in f32 and
# bf16. Against the JAX kernel: f32 tokens equal and logits within 1e-5
# (seen 4.5e-8); bf16 within K7_BF16 (seen max 4.9e-4, mean 1.5e-6, no
# early logit changed). The projection rounded to bf16, planted, changes
# 64% of the first 8 ticks' logits in bf16.
@pytest.mark.parametrize("dtype_j", [jnp.float32, jnp.bfloat16])
def test_staged_k7_matches_plain_and_jax_kernel(pair64, monkeypatch, dtype_j):
    port, lg_j, tok_j = _k7_case(pair64[0], 11, 96, dtype_j, seed=0)
    want = (torch.from_numpy(lg_j), torch.from_numpy(tok_j))
    staged = arnn_kernel.arnn_sampled_decode_staged_reference(*port)
    plain = arnn_kernel.arnn_sampled_decode_reference(*port)
    agree = arnn_kernel.decode_agreement(staged, plain, port[3])
    assert agree["tokens"] == 1.0 and agree["logits_max"] <= 1e-6, agree
    if dtype_j == jnp.float32:
        np.testing.assert_array_equal(staged[1].numpy(), tok_j)
        np.testing.assert_allclose(staged[0].numpy(), lg_j, atol=1e-5, rtol=0)
        return
    assert arnn_kernel.within(arnn_kernel.decode_agreement(staged, want, port[3]), K7_BF16)
    real = arnn_kernel.ctx_projection
    monkeypatch.setattr(arnn_kernel, "ctx_projection",
                        lambda ctx, w: real(ctx, w).to(torch.bfloat16).float())
    planted = arnn_kernel.arnn_sampled_decode_staged_reference(*port)
    agree = arnn_kernel.decode_agreement(planted, want, port[3])
    assert agree["early_changed"] > K7_BF16["early"], agree


def test_kernel_gate():
    assert arnn_kernel_supports(256, 256, 256, 60, torch.bfloat16)  # the flagship
    assert arnn_kernel_supports(512, 512, 256, 60, torch.float32)
    # the small preset and a narrow context: at 64 units, on zero units
    assert arnn_kernel_supports(16, 16, 16, 30, torch.float32)
    assert arnn_kernel_supports(64, 48, 12, 30, torch.float32)
    assert arnn_kernel_supports(512, 512, 512, 60, torch.bfloat16)  # the hidden in rounds
    assert arnn_kernel_supports(256, 256, 1024, 1280, torch.bfloat16)
    # bf16 to H 640 on half-slab boxes, any context width; f32 to 512
    assert arnn_kernel_supports(576, 256, 256, 60, torch.bfloat16)
    assert arnn_kernel_supports(256, 3954, 256, 60, torch.bfloat16)
    assert not arnn_kernel_supports(576, 256, 256, 60, torch.float32)  # past the f32 gate
    assert not arnn_kernel_supports(641, 256, 256, 60, torch.bfloat16)  # past the bf16 gate
    assert not arnn_kernel_supports(64, 64, 12, 30, torch.float16)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def _apply_inpaint_both(jm, pm, batch=3, seq_len=96):
    score, md, loc = make_batch(batch, seq_len)
    lg_j, tok_j = jm.apply_inpaint(jm.params, *map(jnp.asarray, (score, md, loc)), train=False,
                                   rng=jax.random.PRNGKey(1))
    lg, tok = pm.apply_inpaint(pm.params(), *_t(score, md, loc))
    return (lg.numpy(), tok.numpy()), (np.asarray(lg_j), np.asarray(tok_j)), loc


def test_apply_inpaint_through_k7_matches_jax_kernel(pair64, monkeypatch):
    """H 64: the port's gate routes to K7 (its plain version here), the JAX
    package's, forced open, to its kernel in interpret mode."""
    monkeypatch.setenv("INPAINTNET_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JaxCMGR, "_use_pallas_decode", lambda self, p: True)
    jm, pm = pair64
    assert pm._use_kernel_decode(pm.params())
    (lg, tok), (lg_j, tok_j), loc = _apply_inpaint_both(jm, pm)
    np.testing.assert_array_equal(tok, tok_j)
    np.testing.assert_array_equal(tok[loc > 0], make_batch(3, 96)[0][loc > 0])  # forced
    np.testing.assert_allclose(lg, lg_j, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pair16():
    return make_pair(16, seed=2)


def test_apply_inpaint_scan_matches_jax_scan(pair16, monkeypatch):
    """H 16 against the JAX package's XLA scan (its gate is closed on the
    CPU): the port's gate routes to K7 (its plain version here; on the card
    the kernel at 64 units, on zero units), then, the gate closed, to the
    eager loop, which the rest of the test drives."""
    jm, pm = pair16
    assert pm._use_kernel_decode(pm.params())
    for closed in (False, True):
        if closed:
            monkeypatch.setattr(type(pm), "_use_kernel_decode", lambda self, params: False)
        (lg, tok), (lg_j, tok_j), _ = _apply_inpaint_both(jm, pm)
        np.testing.assert_array_equal(tok, tok_j)
        np.testing.assert_allclose(lg, lg_j, atol=1e-5, rtol=0)
    logits = pm.apply(pm.params(), *_t(*make_batch(3, 96)))
    want = jm.apply(jm.params, *map(jnp.asarray, make_batch(3, 96)), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the training branch's sampled decode, JAX's constraint dropout mask
    # (``forward_sampled``: ``r_c, r_scan = split(rng)``) given to the port
    key = jax.random.PRNGKey(6)
    batch = make_batch(3, 96)
    lg_j, tok_j = jm.forward_sampled(jm.params, *map(jnp.asarray, batch), train=True, rng=key)
    keep = np.array(jax.random.bernoulli(jax.random.split(jax.random.split(key)[0])[1],
                                         1.0 - pm.dropout_prob, (3, 96, 16)))
    lg, tok = pm.forward_sampled(pm.params(), *_t(*batch), train=True,
                                 masks={"constraint": [torch.from_numpy(keep)]})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("per_row", [False, True])
def test_generate_with_jax_noise_matches_jax(pair16, per_row):
    """Temperature sampling with the JAX package's own Gumbel draws injected:
    the batch-level stream (one key per tick) and the per-row streams (row
    b's tick keys split from its key)."""
    jm, pm = pair16
    batch, seq_len = 4, 72
    score, md, loc = make_batch(batch, seq_len, seed=5, span=(24, 48))
    if per_row:
        keys = np.random.RandomState(6).randint(0, 2**32, (batch, 2), dtype=np.int64)
        keys = keys.astype(np.uint32)
        temp = np.array([1.5, 0.7, 1.0, 3.0], np.float32)
        _, tok_j = jm.generate(jm.params, *map(jnp.asarray, (score, md, loc)),
                               temperature=jnp.asarray(temp), row_keys=jnp.asarray(keys))
        noise = np.stack([np.stack([np.asarray(jax.random.gumbel(k, (V,), jnp.float32))
                                    for k in jax.random.split(jnp.asarray(row), seq_len)])
                          for row in keys])
    else:
        temp = 1.3
        rng = jax.random.PRNGKey(8)
        _, tok_j = jm.generate(jm.params, *map(jnp.asarray, (score, md, loc)),
                               temperature=temp, rng=rng)
        step_keys = jax.random.split(jax.random.split(rng)[1], seq_len)
        noise = np.stack([np.asarray(jax.random.gumbel(k, (batch, V), jnp.float32))
                          for k in step_keys], axis=1)
    _, tok = pm.generate(pm.params(), *_t(score, md, loc), temperature=temp,
                         gumbel_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    assert (tok.numpy()[loc == 0] != score[loc == 0]).any()  # the span was sampled


def test_generate_streams_on_the_port(pair16):
    """A seeded generator repeats itself; per-row keys make a row's draws
    independent of its batch position."""
    _, pm = pair16
    score, md, loc = _t(*make_batch(3, 48, seed=2, span=(12, 36)))
    p = pm.params()

    def gen(**kw):
        return pm.generate(p, score, md, loc, temperature=1.5, **kw)[1]

    a = gen(generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, gen(generator=torch.Generator().manual_seed(3)))
    keys = torch.tensor([[1, 2], [3, 4], [5, 6]])
    rows = gen(row_keys=keys)
    flipped = pm.generate(p, score.flip(0), md, loc.flip(0), temperature=1.5,
                          row_keys=keys.flip(0))[1]
    assert torch.equal(flipped.flip(0), rows)


# --------------------------------------------------------------------------- #
# parameters and checkpoints
# --------------------------------------------------------------------------- #
def test_convert_matches_export_layout(pair16):
    jm, pm = pair16
    ref = export_anticipation_rnn(_np(jm.params))
    sd = anticipation_rnn_from_jax_params(_np(jm.params))
    assert set(sd) == set(ref) == set(pm.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # and back: the module's nested parameters are the JAX pytree
    back = to_functional(pm.state_dict(), anticipation_rnn_leaves(2, 3))
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(_np(jm.params))[0],
                                 jax.tree_util.tree_flatten_with_path(_np(back))[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    with pytest.raises(RuntimeError, match="Missing key"):
        pm.load_state_dict({k: v for k, v in sd.items() if k != "linear_1.bias"}, strict=True)


def test_jax_checkpoint_loads_into_the_port(pair16, tmp_path):
    jm, _ = pair16
    jm.checkpoint_dir = str(tmp_path)
    jm.save()
    pm = AnticipationRNNBaseline(PortDS(), note_embedding_dim=8, metadata_embedding_dim=4,
                                 num_lstm_constraints_units=16, num_lstm_generation_units=16,
                                 linear_hidden_size=12, num_layers=2, unary_constraint=True,
                                 checkpoint_dir=str(tmp_path), device="cpu", seed=9)
    assert repr(pm) == repr(jm) and pm.filepath == jm.filepath
    pm.load()  # the JAX package's file, found by the same name
    for k, v in export_anticipation_rnn(_np(jm.params)).items():
        np.testing.assert_array_equal(pm.state_dict()[k].numpy(), v, err_msg=k)
    pm.save(str(tmp_path / "port.npz"))  # and the port's file back in the JAX package
    jm2 = JaxARNN(JaxDS(), note_embedding_dim=8, metadata_embedding_dim=4,
                  num_lstm_constraints_units=16, num_lstm_generation_units=16,
                  linear_hidden_size=12, num_layers=2, unary_constraint=True)
    jm2.init(jax.random.PRNGKey(5))
    jm2.load(str(tmp_path / "port.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(jm.params), jax.tree_util.tree_leaves(jm2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_arnn_presets():
    small = build_arnn(small=True, seed=0, device="cpu")
    assert isinstance(small.dataset, ARNNDataset) and small.num_notes == 60
    assert small._use_kernel_decode(small.params())  # H 16: K7 on zero units
    flagship = build_arnn(seed=0, device="meta")
    n = sum(p.numel() for p in flagship.parameters())
    assert 1.9e6 < n < 2.0e6, n
    assert flagship._use_kernel_decode(
        {"lstm_generation": [{"w_hh": torch.empty(0, dtype=torch.bfloat16)}]})
    assert repr(flagship).startswith("AnticipationRNNBaseline(VocabOnlyDataset(arnn,60),10,2,")
