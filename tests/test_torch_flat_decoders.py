"""The flat decoders (``SRDecoder``, ``SRDecoderNoInput``), the multinomial
training decode of ``HierarchicalDecoder`` and ``gru_stack_cell_apply``
against the JAX package on the CPU.

Both sides take the same parameters (JAX's init, jittered so that no bias
is zero) and the same draws: the teacher-forcing coin, the dropout keep
masks and the Gumbel noise are derived from JAX's keys exactly as its
modules derive them, and handed to the port (``coin=``,
``dropout_masks=``, ``gumbel=``).

Bounds: f32 on both sides, sums in another order: logits and gradients
within 2e-5 (seen below 1e-6), tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.measure_vae import HierarchicalDecoder as JaxHierarchicalDecoder
from inpaintnet_tpu.models.measure_vae import SRDecoder as JaxSRDecoder
from inpaintnet_tpu.models.measure_vae import SRDecoderNoInput as JaxSRDecoderNoInput
from inpaintnet_tpu.ops.gru import gru_init as jax_gru_init
from inpaintnet_tpu.ops.gru import gru_stack_cell_apply as jax_gru_stack_cell_apply
from inpaintnet_tpu_torch.models import convert
from inpaintnet_tpu_torch.models.measure_vae import (
    HierarchicalDecoder,
    SRDecoder,
    SRDecoderNoInput,
)
from inpaintnet_tpu_torch.ops.gru import gru_stack_cell_apply

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 2e-5
V, E, Z, L, H, B, T = 20, 6, 8, 2, 16, 5, 24
DROPOUT = 0.3
GEOMETRY = dict(note_embedding_dim=E, num_notes=V, z_dim=Z, num_layers=L, rnn_hidden_size=H)


def _jittered(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
        params)


def _torch(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Z)).astype(np.float32),
            rng.integers(0, V, (B, T)).astype(np.int32),
            rng.standard_normal((B, T, V)).astype(np.float32))


def _key_with_coin(coin: bool):
    """A key whose ``split`` gives the teacher-forcing coin ``coin`` (the
    flat decoders' ``apply``: ``r_flip, r_dec = split(rng)``)."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        r_flip, r_dec = jax.random.split(key)
        if bool(jax.random.bernoulli(r_flip, 0.5)) == coin:
            return key, r_dec
    raise AssertionError("no key gives the coin")


def _stack_masks(k_drop, shape):
    """``gru_stack_cell_apply``'s keep masks of one step from its key."""
    masks = []
    for _ in range(L - 1):
        k_drop, sub = jax.random.split(k_drop)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(sub, 1.0 - DROPOUT, shape))))
    return masks


def _sequential_draws(r_dec, shape, vocab):
    """The sequential branch's per-tick masks and Gumbel noise from JAX's
    keys (``split(r_dec, T)``; a tick's key splits into dropout and sample)."""
    masks, gumbel = [], []
    for key in jax.random.split(r_dec, T):
        k_drop, k_samp = jax.random.split(key)
        masks.append(_stack_masks(k_drop, shape))
        gumbel.append(np.asarray(jax.random.gumbel(k_samp, (shape[0], vocab), jnp.float32)))
    return masks, torch.from_numpy(np.stack(gumbel, axis=1))


def _gru_apply_masks(rng, shape):
    """``gru_apply``'s keep masks from its key (one split a non-last layer)."""
    masks = []
    for _ in range(L - 1):
        rng, sub = jax.random.split(rng)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(sub, 1.0 - DROPOUT, shape))))
    return masks


def _compare(jax_fn, port_fn, jparams):
    """Logits, tokens and the gradients of a loss linear in the logits."""
    w = np.random.default_rng(9).standard_normal((B, T, V)).astype(np.float32)

    def jloss(p):
        logits, samples = jax_fn(p)
        return jnp.sum(logits * w), (logits, samples)

    (_, (j_logits, j_samples)), j_grads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tp = _torch(jparams, grad=True)
    logits, samples = port_fn(tp)
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(samples.numpy(), np.asarray(j_samples))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=ATOL)
    for a, b in zip(_leaves(tp), _leaves(jax.tree_util.tree_map(np.asarray, j_grads))):
        # a leaf the pass never reads (SRDecoderNoInput's embedding) gets
        # no gradient here and zeros in JAX
        got = np.zeros_like(b) if a.grad is None else a.grad.numpy()
        np.testing.assert_allclose(got, b, atol=ATOL)


@pytest.mark.parametrize("sampling", ["argmax", "multinomial"])
@pytest.mark.parametrize("coin", [True, False])
def test_sr_decoder_matches_jax(coin, sampling):
    jdec = JaxSRDecoder(dropout=DROPOUT, **GEOMETRY)
    jdec.sampling = sampling
    dec = SRDecoder(dropout=DROPOUT, device="cpu", **GEOMETRY)
    dec.sampling = sampling
    jparams = _jittered(jdec.init_params(jax.random.PRNGKey(1)), 1)
    z, tokens, _ = _inputs(2)
    key, r_dec = _key_with_coin(coin)
    if coin:
        masks, gumbel = _gru_apply_masks(r_dec, (B, T, H)), None
    else:
        masks, gumbel = _sequential_draws(r_dec, (B, H), V)
    _compare(lambda p: jdec.apply(p, jnp.asarray(z), jnp.asarray(tokens), train=True, rng=key),
             lambda p: dec.apply(p, torch.from_numpy(z), torch.from_numpy(tokens), train=True,
                                 coin=coin, dropout_masks=masks, gumbel=gumbel),
             jparams)


def test_sr_decoder_inference_matches_jax():
    jdec = JaxSRDecoder(dropout=DROPOUT, **GEOMETRY)
    dec = SRDecoder(dropout=DROPOUT, device="cpu", **GEOMETRY)
    jparams = _jittered(jdec.init_params(jax.random.PRNGKey(3)), 3)
    z, tokens, _ = _inputs(4)
    _compare(lambda p: jdec.apply(p, jnp.asarray(z), jnp.asarray(tokens), train=False),
             lambda p: dec.apply(p, torch.from_numpy(z), torch.from_numpy(tokens), train=False),
             jparams)


@pytest.mark.parametrize("train", [True, False])
def test_sr_decoder_no_input_matches_jax(train):
    jdec = JaxSRDecoderNoInput(dropout=DROPOUT, **GEOMETRY)
    dec = SRDecoderNoInput(dropout=DROPOUT, device="cpu", **GEOMETRY)
    jparams = _jittered(jdec.init_params(jax.random.PRNGKey(5)), 5)
    z, tokens, _ = _inputs(6)
    key = jax.random.PRNGKey(11)
    masks = _gru_apply_masks(key, (B, T, H)) if train else None
    _compare(lambda p: jdec.apply(p, jnp.asarray(z), jnp.asarray(tokens), train=train, rng=key),
             lambda p: dec.apply(p, torch.from_numpy(z), torch.from_numpy(tokens), train=train,
                                 dropout_masks=masks),
             jparams)


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_hierarchical_multinomial_decode_matches_jax(teacher_forced):
    """``sampling = "multinomial"`` in training (dropout 0): the tokens are
    JAX's categorical draws, the logits and gradients within 2e-5."""
    jdec = JaxHierarchicalDecoder(dropout=0.0, **GEOMETRY)
    jdec.sampling = "multinomial"
    dec = HierarchicalDecoder(device="cpu", dropout=0.0, **GEOMETRY)
    dec.sampling = "multinomial"
    jparams = _jittered(jdec.init_params(jax.random.PRNGKey(7)), 7)
    z, tokens, _ = _inputs(8)
    rng = jax.random.PRNGKey(13)
    if teacher_forced:
        r_samp = jax.random.split(rng, 3)[2]
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(r_samp, (B, T, V), jnp.float32)))
        _compare(lambda p: jdec.decode_teacher_forced(p, jnp.asarray(z), jnp.asarray(tokens),
                                                      train=True, rng=rng),
                 lambda p: dec.decode_teacher_forced(p, torch.from_numpy(z),
                                                     torch.from_numpy(tokens), train=True,
                                                     gumbel=gumbel),
                 jparams)
    else:
        _, gumbel = _sequential_draws(jax.random.split(rng)[1], (B, H), V)
        _compare(lambda p: jdec.decode_sampling(p, jnp.asarray(z), train=True, rng=rng),
                 lambda p: dec.decode_sampling(p, torch.from_numpy(z), train=True, gumbel=gumbel),
                 jparams)


def test_multinomial_draws_from_the_generator():
    """Without injected noise the multinomial decode draws from the
    generator: the same seed gives the same tokens, argmax other ones."""
    dec = HierarchicalDecoder(device="cpu", dropout=0.0, **GEOMETRY)
    params = _torch(_jittered(dec.init_params(np.random.default_rng(0)), 0))
    z = torch.from_numpy(_inputs(1)[0])

    def run(sampling, seed):
        dec.sampling = sampling
        return dec.decode_sampling(params, z, train=True,
                                   generator=torch.Generator().manual_seed(seed))[1]

    assert torch.equal(run("multinomial", 3), run("multinomial", 3))
    assert not torch.equal(run("multinomial", 3), run("argmax", 3))


@pytest.mark.parametrize("train", [True, False])
def test_gru_stack_cell_matches_jax(train):
    rng = np.random.default_rng(3)
    jparams = _jittered(jax_gru_init(jax.random.PRNGKey(2), 7, H, 3), 2)
    h = rng.standard_normal((3, B, H)).astype(np.float32)
    x = rng.standard_normal((B, 7)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jh, jout = jax_gru_stack_cell_apply(jparams, jnp.asarray(h), jnp.asarray(x),
                                        dropout=DROPOUT, rng=key, train=train)
    masks = []
    k = key
    for _ in range(2):
        k, sub = jax.random.split(k)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(sub, 1 - DROPOUT, (B, H)))))
    th, tout = gru_stack_cell_apply(_torch(jparams), torch.from_numpy(h), torch.from_numpy(x),
                                    dropout=DROPOUT, train=train, dropout_masks=masks)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)


@pytest.mark.parametrize("cls,jcls", [(SRDecoder, JaxSRDecoder),
                                      (SRDecoderNoInput, JaxSRDecoderNoInput),
                                      (HierarchicalDecoder, JaxHierarchicalDecoder)])
def test_reprs_match_jax(cls, jcls):
    assert repr(cls(dropout=DROPOUT, device="cpu", **GEOMETRY)) == repr(
        jcls(dropout=DROPOUT, **GEOMETRY))


@pytest.mark.parametrize("cls,jcls,no_input", [(SRDecoder, JaxSRDecoder, False),
                                               (SRDecoderNoInput, JaxSRDecoderNoInput, True)])
def test_convert_round_trips(cls, jcls, no_input):
    """JAX's parameters -> ``flat_decoder_from_jax_params`` -> the module's
    ``state_dict`` -> ``params()``: JAX's leaves exactly; and the port's own
    ``init_params`` round-trips through ``set_params``."""
    jparams = jax.tree_util.tree_map(np.asarray, jcls(dropout=DROPOUT, **GEOMETRY).init_params(
        jax.random.PRNGKey(8)))
    dec = cls(dropout=DROPOUT, device="cpu", **GEOMETRY)
    dec.load_state_dict(convert.flat_decoder_from_jax_params(jparams, no_input), strict=True)
    back = dec.params()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(_leaves(back), _leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), b)
    own = dec.init_params(np.random.default_rng(1))
    dec.set_params(own)
    for a, b in zip(_leaves(dec.params()), _leaves(own)):
        np.testing.assert_array_equal(a.numpy(), b)
