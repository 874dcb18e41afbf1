"""K3's and K4's plain versions (``encoder_hn_int8_reference``,
``decode_sampling_int8_reference``) against the JAX package's int8 Pallas
kernels (interpret mode, as its own tests run them on the CPU), from the
same seeded numpy inputs.

The integer products are exact on both sides, and every operand the
kernels take (quantized weights, scales, per-row scales, init hiddens) is
bit-equal (``test_torch_quantize.py``). What can differ is f32 gate math
(the two libraries' sigmoid/tanh ulps, and XLA's whole-program fusion of
the jitted kernel wrapper): an ulp that lands on a .5 boundary flips one
int8 rounding of a carry, by one quantum (1/127 of the row's bound), and
the recurrence carries the flip on. The bounds count such quanta where the
two frameworks also round bf16 at different places, and sit near the f32
level otherwise. Planted faults (``test_int8_bounds_reject_planted_faults``)
show that they catch the two traps of these kernels: an ``h_n`` taken from
the dequantized int8 carry instead of the f32 state, and a fed-back token
projection that skips its rounding to the parameter dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.measure_vae import NUM_BEATS_PER_MEASURE, HierarchicalDecoder
from inpaintnet_tpu.ops import encoder_pallas
from inpaintnet_tpu.ops.decode_pallas import decode_sampling_pallas_int8
from inpaintnet_tpu.ops.linear import linear_apply
from inpaintnet_tpu_torch.ops import decode_kernel, encoder_kernel
from inpaintnet_tpu_torch.ops.gru import gru_init
from inpaintnet_tpu_torch.ops.linear import embedding_init
from inpaintnet_tpu_torch.ops.quantize import dequantize_h

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

# K3 h_n. f32: gate ulps only (seen 6e-8 at hidden 64, 9.4e-6 at 128), while
# an h_n taken from the dequantized carry is off by up to half a quantum,
# 0.5/127 = 3.9e-3. bf16: the frameworks round the gates' bf16 inputs at
# different places, which flips carry roundings: four quanta of |h| < 1
# (seen up to 1.8e-2).
HN_ATOL = {"float32": 1e-4, "bfloat16": 4 / 127}
SLAB_SHARE = 0.999  # int8 layer-0 slab entries equal (seen: all)
TOKEN_SHARE = 0.99  # K4 tokens equal (seen: all)
# K4 logits where both decodes fed back the same tokens: a flipped carry
# quantum moves a logit by |head column| * bound / 127; two bf16 ulps of
# logits up to 8 on top (seen: up to 1.6e-2 in bf16; 2.4e-7 in f32, 1.0e-2
# in f32 with init hiddens far above 1). Flips are rare, so the mean error
# stays small (seen: up to 1.8e-4), while a feedback that skips its bf16
# rounding moves many logits (mean 9.8e-4 and 1.4e-3 on the bf16 cases)
LOGITS_ATOL = 0.125
LOGITS_MEAN_ATOL = 5e-4
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _RecordPallasCalls:
    """Stands in for ``pl`` in a JAX kernel module and keeps the outputs of
    every ``pallas_call`` it makes (run eagerly, they are concrete)."""

    def __init__(self, pl):
        self._pl = pl
        self.outputs = []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        call = self._pl.pallas_call(*args, **kwargs)

        def run(*operands):
            out = call(*operands)
            self.outputs.append(out)
            return out

        return run


def _to_torch(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(
            TORCH_DTYPES[dtype]), tree)


def _encoder_inputs(batch, hidden, vocab, dtype, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x + 0.1 * rng.standard_normal(x.shape), dtype),
        gru_init(rng, 10, hidden, 2, True))
    table = jnp.asarray(embedding_init(rng, vocab, 10)["table"], dtype)
    tokens = rng.integers(0, vocab, (batch, 24)).astype(np.int32)
    return params, table, tokens


@pytest.mark.parametrize("batch,hidden,vocab,dtype", [
    (13, 64, 30, "float32"), (37, 64, 60, "bfloat16"), (9, 128, 61, "bfloat16"),
    (9, 128, 61, "float32")])
def test_encoder_int8_reference_matches_pallas(monkeypatch, batch, hidden, vocab, dtype):
    params, table, tokens = _encoder_inputs(batch, hidden, vocab, dtype, seed=batch)
    h_ref, ys_ref = encoder_kernel.encoder_int8_layers_reference(
        _to_torch(params, dtype), _to_torch(table, dtype), torch.from_numpy(tokens))
    h_pallas = encoder_pallas.encoder_hn_pallas_int8(params, table, jnp.asarray(tokens),
                                                     tile_b=8, interpret=True)
    assert h_ref.shape == (4, batch, hidden) and h_ref.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_allclose(h_ref.float().numpy(),
                               np.asarray(h_pallas.astype(jnp.float32)), atol=HN_ATOL[dtype])
    # the int8 layer-0 slab: the first pallas_call's outputs, eagerly
    rec = _RecordPallasCalls(encoder_pallas.pl)
    monkeypatch.setattr(encoder_pallas, "pl", rec)
    encoder_pallas._encoder_hn_pallas_int8.__wrapped__(
        params, table, jnp.asarray(tokens), tile_b=8, ticks_per_step=1, out_dtype=None,
        interpret=True)
    ysf, ysb = (np.asarray(a)[:, :batch] for a in rec.outputs[0][:2])
    assert ysf.dtype == np.int8 and ys_ref.dtype == torch.int8
    share = (ys_ref.numpy() == np.stack([ysf, ysb])).mean()
    assert share >= SLAB_SHARE, share


def _decode_inputs(batch, hidden, dtype, seed, scale_rows=()):
    dec = HierarchicalDecoder(note_embedding_dim=10, num_notes=30, z_dim=16, num_layers=2,
                              rnn_hidden_size=hidden, dropout=0.5)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(x.shape), jnp.float32),
        dec.init_params(jax.random.PRNGKey(seed)))
    z = jnp.asarray(rng.standard_normal((batch, 16)), jnp.float32)
    beat_out = dec._beat_outputs(params, z, train=False, rng=jax.random.PRNGKey(9))
    tick_ctx = jax.nn.selu(linear_apply(params["beat_to_tick_input"], beat_out))
    h_inits = dec._tick_h0(
        params, beat_out.reshape(batch * NUM_BEATS_PER_MEASURE, -1)
    ).reshape(2, batch, NUM_BEATS_PER_MEASURE, -1)
    for row in scale_rows:  # init hiddens far outside (-1, 1)
        h_inits = h_inits.at[:, row].multiply(12.0)
    cast = lambda t: jax.tree_util.tree_map(lambda x: x.astype(dtype), t)  # noqa: E731
    return cast(params), cast(tick_ctx), cast(h_inits)


def _fed_back_same(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(rows, 24) bool: ticks up to and including a row's first token
    mismatch, where both decodes fed back the same tokens."""
    same = np.cumprod(a == b, axis=1)
    return np.concatenate([np.ones_like(same[:, :1]), same[:, :-1]], axis=1).astype(bool)


@pytest.mark.parametrize("batch,hidden,dtype,scale_rows", [
    (13, 64, "float32", ()), (13, 64, "bfloat16", ()), (12, 64, "bfloat16", (0, 5, 11)),
    (9, 128, "float32", (3,))])
def test_decode_int8_reference_matches_pallas(batch, hidden, dtype, scale_rows):
    params, tick_ctx, h_inits = _decode_inputs(batch, hidden, dtype, seed=batch,
                                               scale_rows=scale_rows)
    if scale_rows:
        assert float(jnp.abs(h_inits[:, scale_rows[0]].astype(jnp.float32)).max()) > 4
    lg, s = decode_kernel.decode_sampling_int8_reference(
        *(_to_torch(t, dtype) for t in (params, tick_ctx, h_inits)))
    pw, ps = decode_sampling_pallas_int8(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    pw, ps = np.asarray(pw.astype(jnp.float32)), np.asarray(ps)
    assert lg.shape == (batch, 24, 30) and lg.dtype == TORCH_DTYPES[dtype]
    assert s.dtype == torch.int32
    assert bool(torch.isfinite(lg.float()).all())
    share = (s.numpy() == ps).mean()
    assert share >= TOKEN_SHARE, share
    seen = _fed_back_same(s.numpy(), ps)
    np.testing.assert_allclose(lg.float().numpy()[seen], pw[seen], atol=LOGITS_ATOL)
    assert np.abs(lg.float().numpy()[seen] - pw[seen]).mean() <= LOGITS_MEAN_ATOL


def _unrounded_fed_back_xw(ops, tok, dtype):
    """A planted fault: K4's fed-back token projection without its rounding
    to the parameter dtype."""
    return ops["tok_q"][tok].float() * ops["scales"][3]


@pytest.mark.parametrize("fault,case", [
    ("hn_from_dequantized_carry", (13, 64, 30, "float32")),
    ("unrounded_token_feedback", (13, 64, "bfloat16", ())),
    ("unrounded_token_feedback", (12, 64, "bfloat16", (0, 5, 11)))])
def test_int8_bounds_reject_planted_faults(monkeypatch, fault, case):
    """Each trap, planted in the plain version, breaks the bounds above
    against the Pallas kernel (the f32 case catches the h_n trap: in bf16
    the frameworks' own differences are as large as the fault)."""
    if fault == "hn_from_dequantized_carry":
        batch, hidden, vocab, dtype = case
        params, table, tokens = _encoder_inputs(batch, hidden, vocab, dtype, seed=batch)
        _, ys = encoder_kernel.encoder_int8_layers_reference(
            _to_torch(params, dtype), _to_torch(table, dtype), torch.from_numpy(tokens))
        # layer 0's last carries: forward at t = T-1, backward at t = 0
        planted = torch.stack([dequantize_h(ys[0, -1]), dequantize_h(ys[1, 0])]).numpy()
        h_pallas = encoder_pallas.encoder_hn_pallas_int8(params, table, jnp.asarray(tokens),
                                                         tile_b=8, interpret=True)
        err = np.abs(planted - np.asarray(h_pallas.astype(jnp.float32))[:2]).max()
        assert err > HN_ATOL[dtype], err
        return
    batch, hidden, dtype, scale_rows = case
    params, tick_ctx, h_inits = _decode_inputs(batch, hidden, dtype, seed=batch,
                                               scale_rows=scale_rows)
    monkeypatch.setattr(decode_kernel, "fed_back_xw", _unrounded_fed_back_xw)
    lg, s = decode_kernel.decode_sampling_int8_reference(
        *(_to_torch(t, dtype) for t in (params, tick_ctx, h_inits)))
    pw, ps = decode_sampling_pallas_int8(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    pw, ps = np.asarray(pw.astype(jnp.float32)), np.asarray(ps)
    seen = _fed_back_same(s.numpy(), ps)
    err = np.abs(lg.float().numpy()[seen] - pw[seen])
    assert err.mean() > LOGITS_MEAN_ATOL or err.max() > LOGITS_ATOL, err.mean()


def test_decode_int8_extreme_row_leaves_the_others_bit_equal():
    """The per-row bound: a co-batched row with huge init hiddens leaves the
    other rows' tokens and logits bit-equal to their run without it."""
    params, tick_ctx, h_inits = _decode_inputs(10, 64, "bfloat16", seed=4, scale_rows=(6,))
    args = [_to_torch(t, "bfloat16") for t in (params, tick_ctx, h_inits)]
    lg, s = decode_kernel.decode_sampling_int8_reference(*args)
    keep = [r for r in range(10) if r != 6]
    lg_solo, s_solo = decode_kernel.decode_sampling_int8_reference(
        args[0], args[1][keep], args[2][:, keep])
    assert torch.equal(s[keep], s_solo) and torch.equal(lg[keep], lg_solo)


def test_int8_wrappers_on_cpu_run_the_plain_versions_without_launching():
    params, table, tokens = _encoder_inputs(5, 64, 30, "float32", seed=1)
    enc_args = (_to_torch(params, "float32"), _to_torch(table, "float32"),
                torch.from_numpy(tokens))
    dec_args = [_to_torch(t, "float32") for t in _decode_inputs(6, 64, "float32", seed=2)]
    before = (encoder_kernel.encoder_hn_int8.launches,
              decode_kernel.decode_sampling_int8.launches)
    torch.testing.assert_close(encoder_kernel.encoder_hn_int8(*enc_args),
                               encoder_kernel.encoder_hn_int8_reference(*enc_args),
                               rtol=0, atol=0)
    for got, want in zip(decode_kernel.decode_sampling_int8(*dec_args),
                         decode_kernel.decode_sampling_int8_reference(*dec_args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (encoder_kernel.encoder_hn_int8.launches,
            decode_kernel.decode_sampling_int8.launches) == before
