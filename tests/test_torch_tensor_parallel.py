"""Tensor parallelism in the port (``parallel/mesh.py shard_params``, the
(data, model) mesh, ``parallel/dryrun.py``), on the CPU.

Hidden width 128: ``shard_params`` splits only gate matrices whose output
dimension is a multiple of 128, so a narrower model shards nothing. Ranks
are gloo processes spawned on a free localhost port
(``tests/torch_parallel_worker.py tp_rank_main``): two at (1, 2) and four at
(2, 2).

Bounds, each with its reason:

- the sharded MeasureVAE forward against JAX's unsharded and ``model=2``
  forwards: 1e-5, JAX's own bound (``test_parallel_equivalence.py:80-111``);
- the LatentRNN step (3 Adam steps) on a 1 x 2 mesh against one process:
  1e-6; the gather is exact and the forward the same, so bit-equality is
  expected (and seen); on 2 x 2, 1e-5: the data shards sum their rows
  apart (the data-parallel tests' bound);
- the step's loss against JAX's ``_check_latent_rnn_tp`` on ``devices8``
  with JAX's dropout masks and rsample noise injected: 2e-5, the
  single-device LatentRNN trainer tests' bound.
"""
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import __graft_entry__ as graft
from inpaintnet_tpu.models import MeasureVAE as JaxMeasureVAE
from inpaintnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from inpaintnet_tpu.parallel.mesh import shard_params as jax_shard_params
from inpaintnet_tpu_torch.models.base import flatten_params, iter_leaves, load_jax_checkpoint
from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
from inpaintnet_tpu_torch.ops import gru as gru_mod
from inpaintnet_tpu_torch.parallel import dryrun
from inpaintnet_tpu_torch.parallel.mesh import (
    ShardedLeaf,
    free_port,
    gate_bytes,
    make_mesh,
    shard_params,
)
from inpaintnet_tpu_torch.serve import InpaintingEngine

import torch_parallel_worker as worker
from test_torch_parallel import _reqs, _small_vae_trainer, port_model  # noqa: F401
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

V, B, Z = 24, 8, 12
FORWARD_ATOL = 1e-5
ONE_BY_TWO_ATOL = 1e-6
TWO_BY_TWO_ATOL = 1e-5
LOSS_ATOL = 2e-5


class _FakeDataset:
    def __init__(self, vocab_size=V):
        self.note2index_dicts = [{f"t{i}": i for i in range(vocab_size)}]

    def __repr__(self):
        return "FakeDataset(tp)"


def _jax_vae():
    """JAX's tensor-parallel test model (``test_parallel_equivalence.py``)."""
    model = JaxMeasureVAE(_FakeDataset(), note_embedding_dim=8, num_encoder_layers=2,
                          encoder_hidden_size=128, latent_space_dim=Z, num_decoder_layers=1,
                          decoder_hidden_size=128, encoder_dropout_prob=0.0,
                          decoder_dropout_prob=0.0)
    model.init(jax.random.PRNGKey(2))
    return model


def _jax_sharded_paths(params, devices8) -> set:
    sharded = jax_shard_params(jax_make_mesh(devices=devices8, model=2), params)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]
            if leaf.sharding.spec == P(None, "model")}


@pytest.mark.parametrize("which", ["measure_vae", "latent_rnn"])
def test_shard_params_splits_the_leaves_jax_shards(which, devices8):
    """The leaves ``shard_params`` splits equal those JAX's puts under
    ``P(None, "model")`` on the same trees (model=2), and each holds
    ``1/model`` of its columns on every model index."""
    if which == "measure_vae":
        jax_params = _jax_vae().params
        port = MeasureVAE(_FakeDataset(), note_embedding_dim=8, encoder_hidden_size=128,
                          latent_space_dim=Z, num_decoder_layers=1, decoder_hidden_size=128,
                          device="cpu").params()
    else:
        _, _, jmodel = graft._build_models(**{k: dryrun.SMALL[k] for k in dryrun.SMALL})
        jax_params = jmodel.params
        port = dryrun.build_models(**dryrun.SMALL, device="cpu")[1].params()
    want = _jax_sharded_paths(jax_params, devices8)
    tree = shard_params(make_mesh(data=4, model=2, devices=["cpu"] * 8), port)[0]
    got = {k for k, leaf in iter_leaves(tree) if isinstance(leaf, ShardedLeaf)}
    assert want and got == want
    for k, leaf in iter_leaves(tree):
        if isinstance(leaf, ShardedLeaf):
            full = dict(iter_leaves(port))[k]
            assert [tuple(b.shape) for b in leaf.blocks] == [
                (full.shape[0], full.shape[1] // 2)] * 2
            assert torch.equal(leaf.gather(), full)


@pytest.fixture(scope="module")
def vae_case(tmp_path_factory):
    """JAX's MeasureVAE forward, unsharded and at model=2 on ``devices8``,
    and the inputs the port's ranks read (its parameters, tokens, noise)."""
    devices = jax.devices()[:8]
    model = _jax_vae()
    tokens = np.random.RandomState(1).randint(0, V, (B, 24)).astype(np.int32)
    key = jax.random.PRNGKey(7)

    def fwd(params, batch):
        return model.apply(params, batch, train=False, rng=key)[0]

    ref = np.asarray(jax.jit(fwd)(model.params, tokens))
    sharded = np.asarray(jax.jit(fwd)(
        jax_shard_params(jax_make_mesh(devices=devices, model=2), model.params), tokens))
    eps = np.asarray(jax.random.normal(jax.random.split(key, 4)[1], (B, Z)))
    path = tmp_path_factory.mktemp("tp") / "inputs.npz"
    np.savez(path, tokens=tokens, eps=eps, vocab=V,
             **{f"p/{k}": v for k, v in flatten_params(model.params).items()})
    return str(path), ref, sharded


def _spawn(world: int, model: int, in_path: str, out_dir) -> list:
    mp.start_processes(worker.tp_rank_main,
                       args=(world, free_port(), model, in_path, str(out_dir)), nprocs=world,
                       join=True, start_method="spawn")
    ranks = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


@pytest.fixture(scope="module")
def one_process():
    """The dry-run LatentRNN runs in one process (a 1 x 1 mesh)."""
    mesh = make_mesh(devices=["cpu"])
    return {"eps": worker.tp_latent_run(mesh, 0.0, worker.tp_eps()),
            "drawn": worker.tp_latent_run(mesh, 0.5)}


@pytest.fixture(scope="module")
def ranks_1x2(vae_case, tmp_path_factory):
    return _spawn(2, 2, vae_case[0], tmp_path_factory.mktemp("r12"))


@pytest.fixture(scope="module")
def ranks_2x2(vae_case, tmp_path_factory):
    out = tmp_path_factory.mktemp("r22")
    return _spawn(4, 2, vae_case[0], out), out


def _params(rank: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in rank.items() if k.startswith(prefix + "/")}


def _max_diff(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def test_sharded_vae_forward_matches_jax(vae_case, ranks_1x2):
    """The MeasureVAE forward at model=2 on two gloo ranks and on a local
    mesh naming the CPU twice, against JAX's unsharded and sharded ones."""
    in_path, ref, sharded = vae_case
    np.testing.assert_allclose(sharded, ref, atol=FORWARD_ATOL)
    with np.load(in_path) as z:
        inputs = {k: z[k] for k in z.files}
    weights, _, params = worker.tp_vae_forward(
        make_mesh(data=1, model=2, devices=["cpu", "cpu"]), inputs)
    held, whole = gate_bytes(params)
    assert held == whole > 0  # one process holds both blocks
    for got in [weights] + [r["weights"] for r in ranks_1x2]:
        np.testing.assert_allclose(got, ref, atol=FORWARD_ATOL)
        np.testing.assert_allclose(got, sharded, atol=FORWARD_ATOL)
    np.testing.assert_array_equal(ranks_1x2[0]["weights"], weights)


def test_each_rank_holds_its_share_of_the_gate_bytes(ranks_1x2, ranks_2x2):
    """Each rank's gate matrices (the VAE's, the LatentRNN's and its Adam
    moments) hold exactly 1/model of their bytes, and the ranks sit on the
    (data, model) grid: rank r at (r // 2, r % 2), groups of 2."""
    for ranks in (ranks_1x2, ranks_2x2[0]):
        for r, rank in enumerate(ranks):
            assert (int(rank["data_index"]), int(rank["model_index"])) == (
                (r // 2, r % 2) if len(ranks) == 4 else (0, r))
            assert int(rank["model_group"]) == 2
            assert int(rank["data_group"]) == len(ranks) // 2
            for key in ("vae_bytes", "bytes/latent_rnn", "bytes/vae", "bytes/adam_moments"):
                held, whole = rank[key]
                assert whole > 0 and held * 2 == whole, (key, held, whole)


def test_latent_rnn_step_on_1x2_equals_one_process(one_process, ranks_1x2):
    """Three dry-run steps at model=2 on two ranks, with the draws left to
    the step (dropout 0.5) and with the noise injected (dropout 0), against
    one process: bit-equal (bounded at 1e-6)."""
    for rank in ranks_1x2:
        for run in ("drawn", "eps"):
            assert _max_diff(_params(rank, run), one_process[run]["params"]) <= ONE_BY_TWO_ATOL
            np.testing.assert_allclose(rank[f"{run}_losses"], one_process[run]["losses"],
                                       rtol=0, atol=ONE_BY_TWO_ATOL)


def test_latent_rnn_step_on_2x2_and_its_checkpoint(one_process, ranks_2x2):
    """Three steps on a 2 x 2 mesh (noise injected, dropout 0) within 1e-5
    of one process, every rank alike; the checkpoint rank 0 writes from the
    gathered blocks is the file one process writes, and loads into one."""
    ranks, out = ranks_2x2
    want = one_process["eps"]["params"]
    for rank in ranks:
        assert _max_diff(_params(rank, "eps"), want) <= TWO_BY_TWO_ATOL
        np.testing.assert_allclose(rank["eps_losses"], one_process["eps"]["losses"],
                                   atol=TWO_BY_TWO_ATOL)
    saved = flatten_params(load_jax_checkpoint(str(out / "ckpt.npz")))
    assert {k: v.shape for k, v in saved.items()} == {k: v.shape for k, v in want.items()}
    np.testing.assert_array_equal(saved["generation_rnn/0/0/w_hh"],
                                  _params(ranks[0], "eps")["generation_rnn/0/0/w_hh"])
    _, model = dryrun.build_models(**dryrun.SMALL, device="cpu", seed=9)
    model.load(str(out / "ckpt.npz"))
    assert _max_diff(flatten_params(model.params()), want) <= TWO_BY_TWO_ATOL


def _jax_draws(model, vae, batch):
    """JAX's dropout masks and rsample noise in an eager ``apply`` of the
    dry run's step (``_check_latent_rnn_tp``: key 0): -> (keep masks in draw
    order, the noise)."""
    masks, normals = [], []
    bernoulli, normal = jax.random.bernoulli, jax.random.normal

    def record_bernoulli(key, p=0.5, shape=None):
        out = bernoulli(key, p, shape)
        if np.ndim(out):  # the teacher-forcing coin is a scalar
            masks.append(np.asarray(out))
        return out

    def record_normal(key, shape=(), dtype=np.float32):
        out = normal(key, shape, dtype)
        normals.append(np.asarray(out))
        return out

    past, pm, future, fm, target, tm = batch
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "bernoulli", record_bernoulli)
        m.setattr(jax.random, "normal", record_normal)
        model.apply(model.params, vae.params, past, future, target, past_mask=pm,
                    future_mask=fm, target_mask=tm, train=True, rng=jax.random.PRNGKey(0))
    assert len(normals) == 1
    return masks, normals[0]


def test_latent_rnn_step_loss_matches_jax_tp_step(devices8, monkeypatch):
    """The dry run's step on a local (1, 2) mesh, JAX's masks and noise
    injected, against the loss of ``__graft_entry__._check_latent_rnn_tp``
    at the small geometry on ``devices8`` (a 4 x 2 mesh, 16 rows)."""
    geometry = dict(dryrun.SMALL)
    want = graft._check_latent_rnn_tp(jax_make_mesh(devices=devices8, model=2), 8)
    _, jvae, jmodel = graft._build_models(**geometry)
    batch = graft._example_batch(batch=16, vocab=geometry["vocab"])
    masks, eps = _jax_draws(jmodel, jvae, batch)
    assert len(masks) == 4  # the encoder's, both contexts', the generation GRU's
    vae, model = dryrun.build_models(**geometry, device="cpu")
    vae.set_params(jvae.params)
    model.set_params(jmodel.params)
    queue = [torch.from_numpy(np.array(m)) for m in masks]

    def injected(shape, rate, generator, device):
        keep = queue.pop(0)
        assert tuple(keep.shape) == tuple(shape)
        return keep

    monkeypatch.setattr(gru_mod, "dropout_keep", injected)
    step = dryrun.ShardedLatentRNNStep(make_mesh(data=1, model=2, devices=["cpu", "cpu"]), model)
    eps = torch.from_numpy(np.array(eps)).reshape(16, -1, geometry["z_dim"])
    loss, _ = step.step(batch, eps=eps)
    assert not queue
    assert abs(float(loss) - want) <= LOSS_ATOL, (float(loss), want)


def test_trainer_shrinks_a_2d_mesh_with_the_model_axis(monkeypatch):
    """A 6-row batch on a local (4, 2) mesh: the data axis shrinks to
    gcd(6, 4) = 2 and the model axis stays, with JAX's message; the step runs
    two shards of 3 rows; ``INPAINTNET_STRICT_MESH=1`` raises it."""
    score = torch.from_numpy(np.random.default_rng(2).integers(0, worker.V, (6, 24)).astype(
        np.int32))
    msg = (r"batch size 6 does not divide the 4-way data axis; shrinking the mesh to 2x2 — "
           r"4 device\(s\) will idle")
    monkeypatch.setenv("INPAINTNET_STRICT_MESH", "1")
    with pytest.raises(ValueError, match=msg):
        _small_vae_trainer(make_mesh(data=4, model=2, devices=["cpu"] * 8)).train_step(score)
    monkeypatch.delenv("INPAINTNET_STRICT_MESH")
    tr = _small_vae_trainer(make_mesh(data=4, model=2, devices=["cpu"] * 8))
    rows, loss_and_metrics = [], tr.loss_and_metrics
    tr.loss_and_metrics = lambda p, b, train, **kw: (rows.append(b.shape[0])
                                                     or loss_and_metrics(p, b, train, **kw))
    with pytest.warns(UserWarning, match=msg):
        loss, _ = tr.train_step(score)
    assert tr.mesh.shape == {"data": 2, "model": 2} and len(tr.mesh.devices) == 4
    assert rows == [3, 3] and np.isfinite(float(loss))


def test_engine_on_a_2x2_mesh_equals_no_mesh(port_model):  # noqa: F811
    """A local (2, 2) mesh shards requests over "data" and replicates the
    weights on each data index's device, (d, 0) of the grid (the model
    column names ``meta``, where nothing may run): ``inpaint_hetero``
    bit-equal to the engine without a mesh."""
    single = InpaintingEngine(port_model, batch_buckets=(8,), dtype="float32")
    mesh = make_mesh(data=2, model=2, devices=["cpu", "meta"] * 2)
    sharded = InpaintingEngine(port_model, batch_buckets=(8,), dtype="float32", mesh=mesh)
    assert len(sharded._replicas) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for x, y in zip(single.inpaint_hetero(_reqs()), sharded.inpaint_hetero(_reqs())):
            np.testing.assert_array_equal(x, y)
