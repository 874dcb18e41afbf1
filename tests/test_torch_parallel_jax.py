"""The port's data-parallel trainers against the JAX package's, on the CPU.

The JAX side runs its trainers on a 2-device mesh of virtual CPU devices
(``devices8``) under ``INPAINTNET_TRAIN_GRU_IMPL=trainfast_pallas``, which
takes the kernel-bearing ``shard_map`` step (``grads_per_shard``,
``inpaintnet_tpu/train/trainer.py:295-315``: shard d's key is
``fold_in(key, d)``, each shard flips its own coin, the loss is the mean of
the shards' means; the kernels gate off on the CPU, so both sides run the
same scans and the comparison isolates the distribution). The port's side
runs its trainers on a local mesh of the CPU named twice, with JAX's
per-shard draws injected row by row: the VAE (the rsample noise, dropout 0)
and the ARNN baseline (a masked loss; every dropout mask, dropout 0.5).
Steps whose shards flip one coin are chosen, as the port takes one injected
coin.

Bounds: loss and accuracy each step within 2e-5, as the single-device
trainer tests hold them; the parameters after three Adam steps within 1e-5
(``ADAM_ATOL`` says why). The draws injected in the other shard order break
them. With the coin left free, the port's shards flip different coins, as
JAX's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.presets import VocabOnlyDataset as JaxVocabOnlyDataset
from inpaintnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from inpaintnet_tpu.parallel.mesh import replicate as jax_replicate
from inpaintnet_tpu.parallel.mesh import shard_batch as jax_shard_batch
from inpaintnet_tpu.train.arnn_trainer import AnticipationRNNBaselineTrainer as JaxBaselineTrainer
from inpaintnet_tpu.train.vae_trainer import VAETrainer as JaxVAETrainer
from inpaintnet_tpu_torch.models import measure_vae as tmv
from inpaintnet_tpu_torch.models.base import flatten_params, iter_leaves
from inpaintnet_tpu_torch.parallel.mesh import make_mesh
from inpaintnet_tpu_torch.train import AnticipationRNNBaselineTrainer
from inpaintnet_tpu_torch.train.data import ArrayDataset
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

import test_torch_arnn_train as arnn_t
import test_torch_vae_train as vae_t
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

SHARDS = 2
LOSS_ATOL = 2e-5
# a first Adam step moves an element by lr * g / (|g| + 1e-8): where a
# gradient element lies near Adam's eps, the f32 rounding of the shard mean
# is amplified about 1e5 times. Seen: a VAE log_std head weight whose
# gradient is 2.3e-8 moved 2.6e-6 apart after one step (a hundredth of a
# step of lr 1e-3 is 1e-5); every loss and accuracy within 5e-7.
ADAM_ATOL = 1e-5


@pytest.fixture
def jax_shard_map(devices8, monkeypatch):
    """A 2-device JAX mesh whose trainers take the shard_map step (the
    kernels gate off on the CPU: the same scans, so the comparison isolates
    the distribution)."""
    monkeypatch.setenv("INPAINTNET_TRAIN_GRU_IMPL", "trainfast_pallas")
    return jax_make_mesh(devices=devices8[:SHARDS])


def _jax_steps(jtr, batches):
    """JAX's compiled train step over (batch, key): -> (the parameters after,
    [(loss, accuracy)] a step)."""
    assert jtr._use_shard_map_train()
    jtr._build_steps()
    params, opt_state, seen = jax_replicate(jtr.mesh, jtr.model.params), jtr.opt_state, []
    for batch, key in batches:
        params, opt_state, loss, metrics = jtr._train_step(
            params, opt_state, jax_shard_batch(jtr.mesh, batch), key, None)
        seen.append((float(loss), float(metrics["accuracy"])))
    return flatten_params(jax.tree_util.tree_map(np.asarray, params)), seen


def _port_steps(tr, batches):
    seen = []
    for batch, inject in batches:
        loss, metrics = tr.train_step(batch, **inject)
        seen.append((float(loss), float(metrics["accuracy"])))
    return {k: p.detach().numpy() for k, p in iter_leaves(tr.params)}, seen


def _same_steps(got, want):
    (params, seen), (w_params, w_seen) = got, want
    np.testing.assert_allclose(seen, w_seen, rtol=0, atol=LOSS_ATOL)
    assert params.keys() == w_params.keys()
    err = max(np.abs(params[k] - w_params[k]).max() for k in w_params)
    assert err <= ADAM_ATOL, err


def _agreeing_key(coins_of, want, start):
    """A step key whose shards all flip ``want``."""
    for seed in range(start, start + 200):
        key = jax.random.PRNGKey(seed)
        if coins_of(key) == [want] * SHARDS:
            return key
    raise AssertionError("no key gives every shard that coin")


def _vae_shard_draws(key, rows):
    """JAX's draws in ``grads_per_shard`` for the VAE: shard d's key
    ``fold_in(key, d)``, ``MeasureVAE.apply``'s split into (r_enc, r_z,
    r_prior, r_dec), the rsample noise ``normal(r_z)`` over the shard's rows
    and the decoder's coin ``bernoulli(split(r_dec)[0], 0.5)``. -> (noise
    of the global batch's rows, the shards' coins)"""
    eps, coins = [], []
    for d in range(SHARDS):
        _, r_z, _, r_dec = jax.random.split(jax.random.fold_in(key, d), 4)
        eps.append(np.asarray(jax.random.normal(r_z, (rows, vae_t.Z), jnp.float32)))
        coins.append(bool(jax.random.bernoulli(jax.random.split(r_dec)[0], 0.5)))
    return eps, coins


def _vae_batches():
    rng = np.random.default_rng(8)
    rows = vae_t.ROWS * 2 // SHARDS  # a shard's measure rows
    jax_b, port_b, swapped = [], [], []
    for step, coin in enumerate((True, False, True)):
        score = rng.integers(0, vae_t.V, (vae_t.ROWS * 2, 24)).astype(np.int32)
        key = _agreeing_key(lambda k: _vae_shard_draws(k, rows)[1], coin, 100 * step)
        eps = _vae_shard_draws(key, rows)[0]
        jax_b.append((score, key))
        port_b.append((torch.from_numpy(score),
                       {"eps": torch.from_numpy(np.concatenate(eps)), "coin": coin}))
        swapped.append((port_b[-1][0],
                        {"eps": torch.from_numpy(np.concatenate(eps[::-1])), "coin": coin}))
    return jax_b, port_b, swapped


def test_vae_shards_match_jax_shard_map(jax_shard_map):
    """The VAE trainer (H 16, dropout 0) three Adam steps on 12-row global
    batches, two shards: the port against JAX's shard_map step."""
    jvae, port = vae_t._models(vae_t.H)
    jtr = JaxVAETrainer(JaxVocabOnlyDataset(vae_t.V), jvae, lr=vae_t.LR, mesh=jax_shard_map)
    jax_b, port_b, swapped = _vae_batches()
    want = _jax_steps(jtr, jax_b)
    data = ArrayDataset((np.zeros((1, 1, 48), np.int32),), 2)

    def port_run(batches):
        tr = VAETrainer(data, port, lr=vae_t.LR, device="cpu",
                        mesh=make_mesh(devices=["cpu"] * SHARDS))
        return _port_steps(tr, batches)

    _same_steps(port_run(port_b), want)
    with pytest.raises(AssertionError):  # each shard's noise on the other's rows
        _same_steps(port_run(swapped), want)


def _arnn_batches(model, jtr):
    """Three steps of the ARNN baseline (teacher forcing on), each shard's
    coin and keep masks drawn as JAX's step draws them from ``fold_in(key,
    d)``, concatenated over the shards' rows."""
    rows = arnn_t.B // SHARDS
    jax_b, port_b, swapped = [], [], []
    for step, coin in enumerate((True, False, True)):
        batch = jtr.process_batch_data(arnn_t._windows(30 + step))
        keys = [lambda k, d=d: jax.random.fold_in(k, d) for d in range(SHARDS)]
        key = _agreeing_key(
            lambda k: [bool(jax.random.bernoulli(jax.random.split(f(k))[0], 0.5)) for f in keys],
            coin, 100 * step)
        masks = [arnn_t._jax_masks(f(key), model, False, coin, rows) for f in keys]

        def joined(order):
            return {name: ([torch.cat([m[name][i] for m in order])
                            for i in range(len(masks[0][name]))]
                           if isinstance(masks[0][name], list)
                           else torch.cat([m[name] for m in order]))
                    for name in masks[0]}

        jax_b.append((batch, key))
        port_b.append((arnn_t._tensors(batch), {"coin": coin, "masks": joined(masks)}))
        swapped.append((port_b[-1][0], {"coin": coin, "masks": joined(masks[::-1])}))
    return jax_b, port_b, swapped


def test_arnn_shards_match_jax_shard_map(jax_shard_map):
    """The ARNN baseline trainer (dropout 0.5, its loss a mean over the
    unconstrained ticks) three Adam steps on 4-row global batches, two
    shards: the port against JAX's shard_map step."""
    jmodel, model = arnn_t._models("baseline", 0.5, True, seed=3)
    jtr = JaxBaselineTrainer(arnn_t.DATA, jmodel, lr=arnn_t.LR, seed=0, mesh=jax_shard_map)
    jax_b, port_b, swapped = _arnn_batches(model, jtr)
    want = _jax_steps(jtr, jax_b)

    def port_run(batches):
        tr = AnticipationRNNBaselineTrainer(arnn_t.DATA, model, lr=arnn_t.LR, seed=0,
                                            device="cpu",
                                            mesh=make_mesh(devices=["cpu"] * SHARDS))
        return _port_steps(tr, batches)

    _same_steps(port_run(port_b), want)
    with pytest.raises(AssertionError):  # each shard's masks on the other's rows
        _same_steps(port_run(swapped), want)


def test_shards_flip_their_own_coins(monkeypatch):
    """With the coin left free, each shard of a step flips its own (the
    port's trainer on a mesh of the CPU named twice, eight VAE steps): the
    shards' coins differ at some step and agree at another, as JAX's
    ``fold_in`` gives its shards different coins."""
    flips = []
    flip = tmv._flip
    monkeypatch.setattr(tmv, "_flip", lambda *a: flips.append(flip(*a)) or flips[-1])
    _, port = vae_t._models(vae_t.H)
    data = ArrayDataset((np.zeros((1, 1, 48), np.int32),), 2)
    tr = VAETrainer(data, port, lr=vae_t.LR, device="cpu", mesh=make_mesh(devices=["cpu"] * 2))
    score = torch.from_numpy(np.random.default_rng(9).integers(0, vae_t.V, (8, 24)).astype(
        np.int32))
    for _ in range(8):
        tr.train_step(score)
    pairs = [tuple(flips[i:i + 2]) for i in range(0, len(flips), 2)]
    assert len(pairs) == 8
    assert any(a != b for a, b in pairs) and any(a == b for a, b in pairs)
    jax_pairs = [_vae_shard_draws(jax.random.PRNGKey(seed), 1)[1] for seed in range(8)]
    assert any(a != b for a, b in jax_pairs)
