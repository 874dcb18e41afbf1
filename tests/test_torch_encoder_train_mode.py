"""K1's training mode (``encoder_hn(keep=, rate=)``) and the encoder's
training route through it, against the JAX package on the CPU.

JAX's side is its Pallas kernel in interpret mode
(``encoder_hn_pallas(keep=, rate=, interpret=True)``) and its opt-in route
``Encoder._apply_train_pallas`` under ``INPAINTNET_TRAIN_ENCODER_IMPL=pallas``;
the port's is K1's plain version (the wrapper's CPU route) and
``Encoder.apply(train=True)`` under the same switch. Inputs and keep masks
are made with numpy from a seed (or drawn by JAX and handed to the port).

Bounds: f32 on both sides, only the summation order differs, so 1e-5 for
h_n (seen below 1e-6); the route against JAX's, 1e-4 for values and
gradients, as JAX's own ``test_encoder_train_route_values_and_grads_match_scan``
holds its two routes. The planted fault, the mask read at a chunk's local
rows instead of its global ones, must break the h_n bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.measure_vae import Encoder as JaxEncoder
from inpaintnet_tpu.ops.encoder_pallas import encoder_hn_pallas
from inpaintnet_tpu_torch.models.measure_vae import Encoder
from inpaintnet_tpu_torch.ops import encoder_kernel as ek
from inpaintnet_tpu_torch.ops.distributions import apply_dropout
from inpaintnet_tpu_torch.ops.gru import gru_init
from inpaintnet_tpu_torch.ops.linear import embedding_init

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-5
ROUTE_ATOL = 1e-4
CHUNK = 8  # max_chunk_rows: a batch of 13 spans two chunks


def _inputs(batch, hidden, rate, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        gru_init(rng, 10, hidden, 2, True))
    table = embedding_init(rng, 30, 10)["table"]
    tokens = rng.integers(0, 30, (batch, 24)).astype(np.int32)
    keep = rng.random((batch, 24, 2 * hidden)) >= rate
    return params, table, tokens, keep


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)


def _jax_hn(params, table, tokens, keep, rate):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(encoder_hn_pallas(jp, jnp.asarray(table), jnp.asarray(tokens), tile_b=8,
                                        interpret=True, keep=jnp.asarray(keep), rate=rate))


@pytest.mark.parametrize("hidden", [16, 32])
@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_plain_training_mode_matches_pallas(hidden, rate, monkeypatch):
    params, table, tokens, keep = _inputs(13, hidden, rate, seed=hidden + int(10 * rate))
    want = _jax_hn(params, table, tokens, keep, rate)
    args = (_torch(params), torch.from_numpy(table), torch.from_numpy(tokens))
    k = torch.from_numpy(keep)
    got = ek.encoder_hn(*args, keep=k, rate=rate)  # the wrapper's CPU route
    staged = ek.encoder_hn_staged_reference(*args, keep=k, rate=rate, max_chunk_rows=CHUNK)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(staged.numpy(), want, atol=ATOL)
    # layer 0's h_n is never dropped, layer 1's is
    plain = ek.encoder_hn_reference(*args)
    np.testing.assert_array_equal(got[:2].numpy(), plain[:2].numpy())
    assert np.abs(got[2:].numpy() - plain[2:].numpy()).max() > 100 * ATOL
    # the planted fault: each chunk reads the mask at its local rows
    monkeypatch.setattr(ek, "chunk_keep", lambda keep, row0, rows: keep[:rows])
    faulty = ek.encoder_hn_staged_reference(*args, keep=k, rate=rate, max_chunk_rows=CHUNK)
    assert np.abs(faulty.numpy() - want).max() > 100 * ATOL


def test_dropped_divides_truly():
    """The port's one dropout (``apply_dropout``, which K1's plain training
    mode uses too) divides by 1 - rate in f32, rounded once: at rate 0.3 a
    multiplication by f32(1 / 0.7) differs on some elements. In bf16 it is
    the f32 quotient rounded to bf16 once."""
    y = torch.linspace(-1, 1, 4001)
    keep = torch.ones_like(y, dtype=torch.bool)
    got = apply_dropout(y, keep, 0.3)
    want = torch.from_numpy(y.numpy() / np.float32(0.7))
    assert torch.equal(got, want)
    assert not torch.equal(got, y * np.float32(1 / 0.7))
    assert torch.equal(apply_dropout(y, ~keep, 0.3), torch.zeros_like(y))
    yb = y.to(torch.bfloat16)
    assert torch.equal(apply_dropout(yb, keep, 0.3),
                       (yb.float() / torch.tensor(0.7)).to(torch.bfloat16))


def _port_encoder(hidden, dropout):
    return Encoder(8, hidden, 2, 30, 12, device="cpu", dropout=dropout)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _grad_copy(tree):
    return jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x, np.float32)).requires_grad_(True), tree)


def test_route_switch_values_and_grads(monkeypatch):
    """``Encoder.apply(train=True)`` with the switch on (K1's training mode,
    its plain version here) and off (the trainfast route), from one seeded
    generator: the same mask, so values and gradients agree within 1e-5.
    The twin of JAX's ``test_encoder_train_route_values_and_grads_match_scan``."""
    hidden = 64
    enc = _port_encoder(hidden, 0.5)
    assert enc.use_kernel()
    params = enc.init_params(np.random.default_rng(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 30, (6, 24)).astype(np.int32))

    def run(switch):
        if switch:
            monkeypatch.setenv("INPAINTNET_TRAIN_ENCODER_IMPL", "pallas")
        else:
            monkeypatch.delenv("INPAINTNET_TRAIN_ENCODER_IMPL", raising=False)
        assert enc.use_train_kernel() == switch
        p = _grad_copy(params)
        dist = enc.apply(p, tokens, train=True, generator=torch.Generator().manual_seed(7))
        loss = (dist.loc ** 2).sum() + dist.scale.sum()
        loss.backward()
        return loss.item(), [x.grad for x in _leaves(p)]

    v_on, g_on = run(True)
    v_off, g_off = run(False)
    np.testing.assert_allclose(v_on, v_off, atol=ATOL)
    for a, b in zip(g_on, g_off):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


@pytest.mark.parametrize("hidden", [16, 64])
def test_route_matches_jax_apply_train_pallas(monkeypatch, hidden):
    """The port's route against JAX's ``_apply_train_pallas`` (interpret
    mode), JAX's keep mask injected as ``dropout_masks``: z's mean and
    scale, and the gradients of a loss of both, within 1e-4. At H 16 the
    port's K1 gate is closed, so the route is called directly."""
    monkeypatch.setenv("INPAINTNET_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("INPAINTNET_TRAIN_ENCODER_IMPL", "pallas")
    jenc = JaxEncoder(note_embedding_dim=8, rnn_hidden_size=hidden, num_layers=2,
                      num_notes=30, dropout=0.5, bidirectional=True, z_dim=12)
    params = jenc.init_params(jax.random.PRNGKey(0))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (6, 24), 0, 30), np.int32)
    rng = jax.random.PRNGKey(7)
    # JAX's draw (_apply_train_pallas: one split, then bernoulli)
    keep = np.array(jax.random.bernoulli(jax.random.split(rng)[1], 0.5, (6, 24, 2 * hidden)))

    def jax_loss(p):
        dist = jenc._apply_train_pallas(p, jnp.asarray(tokens), rng)
        return jnp.sum(dist.loc ** 2) + jnp.sum(dist.scale)

    v_jax, g_jax = jax.value_and_grad(jax_loss)(params)
    enc = _port_encoder(hidden, 0.5)
    p = _grad_copy(params)
    dist = enc._apply_train_kernel(p, torch.from_numpy(tokens), None, [torch.from_numpy(keep)])
    loss = (dist.loc ** 2).sum() + dist.scale.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_jax), atol=ROUTE_ATOL)
    for a, b in zip(_leaves(p), _leaves(jax.tree_util.tree_map(np.asarray, g_jax))):
        np.testing.assert_allclose(a.grad.numpy(), b, atol=ROUTE_ATOL)
