"""Data parallelism in the port (``inpaintnet_tpu_torch/parallel/mesh.py``,
the trainer's ``mesh=`` and the engine's), on the CPU.

Twins of the JAX package's ``tests/test_parallel_equivalence.py`` mesh
arithmetic, and of its ``test_dp8_matches_single_device`` and
``tests/test_multiprocess.py``: the VAE trainer in two gloo processes (and
on a local mesh naming the CPU twice) against one process on the same
global batches. The two runs differ only in the order of f32 sums (each
shard's loss and gradient is summed apart, then averaged), so the
parameters after three Adam steps and the eval tail's loss and accuracy
are held within 1e-5 (seen below 1e-7). The engine on a mesh of the CPU
named twice and four times is held bit-equal to the engine without one:
per-row keys travel with their rows.

Against the JAX package: its trainers on a 2-device mesh of virtual CPU
devices (``devices8``) under ``INPAINTNET_TRAIN_GRU_IMPL=trainfast_pallas``,
which takes the kernel-bearing ``shard_map`` step (``grads_per_shard``,
``inpaintnet_tpu/train/trainer.py:295-315``: shard d's key is
``fold_in(key, d)``, each shard flips its own coin, the loss is the mean of
the shards' means), beside the port's trainers on a local mesh of the CPU
named twice, with JAX's per-shard draws injected row by row: the VAE (the
rsample noise, dropout 0) and the ARNN baseline (a masked loss; every
dropout mask, dropout 0.5). Steps whose shards flip one coin are chosen, as
the port takes one injected coin. Loss and accuracy each step within 2e-5,
as the single-device trainer tests hold them, and the parameters after
three Adam steps within 1e-5 (``ADAM_ATOL`` says why); the draws injected in
the other shard order break them. With the coin left free, the port's shards flip different
coins, as JAX's do.
"""
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp


from inpaintnet_tpu_torch.models.presets import build_arnn, build_flagship
from inpaintnet_tpu_torch.parallel import mesh as mesh_mod
from inpaintnet_tpu_torch.parallel.mesh import (
    free_port,
    local_batch_size,
    make_global_batch,
    make_mesh,
    pad_rows_to_divisible,
    shard_batch,
)
from inpaintnet_tpu_torch.serve import InpaintingEngine
from inpaintnet_tpu_torch.train import AnticipationRNNBaselineTrainer
from inpaintnet_tpu_torch.train.data import ArrayDataset

import torch_parallel_worker as worker
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-5


def test_local_batch_size_validates(monkeypatch):
    """Per-process row math for a (simulated) 4-process run."""
    m = make_mesh(devices=["cpu"] * 8)
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 4)
    assert local_batch_size(m, 32) == 8
    with pytest.raises(ValueError):
        local_batch_size(m, 30)


def test_pad_rows_to_divisible_math():
    """Eval-tail padding: smallest local row count whose global total
    divides the data axis, zero fill, correct validity mask."""
    batch = {"x": np.ones((5, 3), np.float32), "y": np.arange(5, dtype=np.int32)}
    same, mask = pad_rows_to_divisible(batch, data_axis=4, process_count=4)
    assert mask is None and same is batch
    # 5 rows x 4 procs = 20 % 24 != 0; step = 24/gcd(24,4) = 6 -> pad to 6
    padded, mask = pad_rows_to_divisible(batch, data_axis=24, process_count=4)
    assert padded["x"].shape == (6, 3) and padded["y"].shape == (6,)
    np.testing.assert_array_equal(mask, [1, 1, 1, 1, 1, 0])
    np.testing.assert_array_equal(padded["x"][:5], batch["x"])
    np.testing.assert_array_equal(padded["x"][5], 0.0)
    assert padded["y"].dtype == batch["y"].dtype
    # single process, 8-way axis: 5 -> 8; tensors pad too
    padded, mask = pad_rows_to_divisible(batch, data_axis=8, process_count=1)
    assert padded["x"].shape == (8, 3)
    assert mask.sum() == 5 and mask.shape == (8,)
    padded, _ = pad_rows_to_divisible(torch.ones((5, 2)), data_axis=2, process_count=1)
    assert torch.equal(padded, torch.cat([torch.ones((5, 2)), torch.zeros((1, 2))]))


def test_make_global_batch_single_process():
    """Single-process make_global_batch == shard_batch on a divisible batch
    (values, devices and per-shard shapes)."""
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8, "model": 1} and local_batch_size(mesh, 16) == 16
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    batch = {"x": x, "y": np.arange(16, dtype=np.int32)}
    g, s = make_global_batch(mesh, batch), shard_batch(mesh, batch)
    assert len(g) == len(s) == 8
    for i, (a, b) in enumerate(zip(g, s)):
        assert a["x"].shape == (2, 3) and a["y"].shape == (2,)
        assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
        np.testing.assert_array_equal(a["x"].numpy(), x[2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="does not divide the 8-way data axis"):
        make_global_batch(mesh, {"x": x[:6]})


def test_shard_batch_replicates_an_indivisible_batch(monkeypatch):
    monkeypatch.setattr(mesh_mod, "_warned", False)
    mesh = make_mesh(devices=["cpu"] * 4)
    with pytest.warns(UserWarning, match="replicating"):
        shards = shard_batch(mesh, {"x": np.arange(6)})
    assert all(np.array_equal(s["x"].numpy(), np.arange(6)) for s in shards)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once a process
        shard_batch(mesh, {"x": np.arange(6)})
    copies = mesh_mod.replicate(mesh, {"w": np.ones(2)})
    assert len(copies) == 4 and copies[0] is copies[3]


def test_mesh_shapes_and_the_model_axis(monkeypatch):
    """The 2-D mesh's arithmetic: a local mesh's (data, model) grid in
    row-major order; a world rank r at (r // model, r % model), its model
    group the ranks of its data index and its data group those of its model
    index, every rank making the groups in one order; the shape checks."""
    with pytest.raises(ValueError, match="2x1 mesh != 3 devices"):
        make_mesh(data=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="2x2 mesh != 3 devices"):
        make_mesh(data=2, model=2, devices=["cpu"] * 3)
    assert make_mesh(num_devices=2, devices=["cpu"] * 4).shape["data"] == 2
    local = make_mesh(data=1, model=2, devices=["cpu"] * 2)
    assert local.shape == {"data": 1, "model": 2} and local.local_indices() == [0]
    assert local.model_indices() == [0, 1]
    grid = make_mesh(model=2, devices=["cpu", "meta", "cpu", "meta"])
    assert grid.shape == {"data": 2, "model": 2}
    assert [grid.device_of(d, m).type for d in (0, 1) for m in (0, 1)] == [
        "cpu", "meta", "cpu", "meta"]
    made = []
    monkeypatch.setattr(mesh_mod.dist, "new_group", lambda ranks: made.append(ranks) or
                        tuple(ranks))
    for rank in range(6):
        monkeypatch.setattr(mesh_mod, "process_index", lambda r=rank: r)
        made.clear()
        world = mesh_mod.Mesh(["cpu"], 3, 2, distributed=True)
        assert made == [[0, 1], [2, 3], [4, 5], [0, 2, 4], [1, 3, 5]]
        assert world.local_indices() == [rank // 2] and world.model_indices() == [rank % 2]
        assert world.model_group == tuple(range(rank // 2 * 2, rank // 2 * 2 + 2))
        assert world.data_group == (rank % 2, rank % 2 + 2, rank % 2 + 4)
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 6)
    assert local_batch_size(world, 12) == 4  # model peers feed the same rows
    with pytest.raises(ValueError, match="2x2 mesh != 6 processes"):
        make_mesh(data=2, model=2)


@pytest.fixture(scope="module")
def one_process():
    return worker.vae_run()


def _same_run(got, want, rows):
    params, loss, acc, seen = got
    w_params, w_loss, w_acc, w_seen = want
    assert w_seen == [12, 12, 12, 7] and seen == rows  # the shards' rows
    assert params.keys() == w_params.keys()
    for k in params:
        np.testing.assert_allclose(params[k], w_params[k], atol=ATOL, err_msg=k)
    np.testing.assert_allclose(loss, w_loss, atol=ATOL)
    np.testing.assert_allclose(acc, w_acc, atol=ATOL)


def test_two_gloo_processes_match_one(one_process, tmp_path):
    """The VAE trainer in two processes of a gloo group (the default mesh:
    the world, one shard a rank), three Adam steps and an eval tail of 7
    rows padded to 8, against one process."""
    out = tmp_path / "rank0.npz"
    mp.start_processes(worker.rank_main, args=(2, free_port(), str(out)), nprocs=2,
                       join=True, start_method="spawn")
    with np.load(out) as z:
        got = ({k: z[k] for k in z.files if k not in ("loss", "acc", "rows")},
               float(z["loss"]), float(z["acc"]), z["rows"].tolist())
    _same_run(got, one_process, [6, 6, 6, 4])


def test_local_mesh_of_one_device_named_twice_matches_one(one_process):
    """A local mesh naming the trainer's CPU twice: two shards in turn."""
    _same_run(worker.vae_run(mesh=make_mesh(devices=["cpu", "cpu"])), one_process,
              [6, 6] * 3 + [4, 4])


def test_cli_joins_the_group_torchrun_names(tmp_path):
    """Two ranks with ``torchrun``'s environment: the trainers'
    ``train_device("cpu")`` initialises a gloo group of both, and an
    all-reduce averages over it; ``resolve_device``, which the other entry
    points call, joins none."""
    out = tmp_path / "rank0.npz"
    mp.start_processes(worker.cli_rank_main, args=(2, free_port(), str(out)), nprocs=2,
                       join=True, start_method="spawn")
    with np.load(out) as z:
        assert str(z["backend"]) == "gloo" and int(z["world"]) == 2
        assert str(z["device"]) == "cpu" and float(z["mean"][0]) == 0.5


class _ArnnWindows(ArrayDataset):
    subdivision, num_beats_per_bar = 6, 4


def test_arnn_eval_tail_on_a_mesh_matches_one_device():
    """An ARNN trainer's 7-row eval batch on a mesh of the CPU named twice
    (padded to 8, the pad row masked out through ``row_mask``) against one
    device: the same loss and accuracy (the argmax decode draws nothing)."""
    rng = np.random.default_rng(3)
    ticks = 9 * 24
    score = rng.integers(0, 60, (7, 1, ticks)).astype(np.int32)
    metadata = np.zeros((7, 1, ticks, 3), np.int32)
    ds = _ArnnWindows([score, metadata], 9)
    model = build_arnn(small=True, device="cpu", seed=0)
    one = AnticipationRNNBaselineTrainer(ds, model, device="cpu")
    mesh = AnticipationRNNBaselineTrainer(ds, model, device="cpu",
                                          mesh=make_mesh(devices=["cpu"] * 2))
    batch = one.process_batch_data((score, metadata))
    (l1, m1), (l2, m2) = one.eval_step(batch), mesh.eval_step(batch)
    np.testing.assert_allclose(float(l2), float(l1), atol=ATOL)
    np.testing.assert_allclose(float(m2["accuracy"]), float(m1["accuracy"]), atol=ATOL)


def _small_vae_trainer(mesh):
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
    from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

    model = MeasureVAE(VocabOnlyDataset(worker.V), note_embedding_dim=6,
                       encoder_hidden_size=worker.H, latent_space_dim=worker.Z,
                       decoder_hidden_size=worker.H, device="cpu", seed=0)
    data = ArrayDataset((np.zeros((1, 1, 48), np.int32),), 2)
    return VAETrainer(data, model, lr=1e-3, device="cpu", mesh=mesh)


def test_trainer_shrinks_the_mesh_for_an_indivisible_batch(monkeypatch):
    """A 6-row batch on a local mesh of four: the data axis shrinks to
    gcd(6, 4) = 2 with the JAX trainer's warning and the step runs two
    shards of 3 rows; under ``INPAINTNET_STRICT_MESH=1`` the same raises."""
    score = torch.from_numpy(np.random.default_rng(2).integers(0, worker.V, (6, 24)).astype(
        np.int32))
    monkeypatch.setenv("INPAINTNET_STRICT_MESH", "1")
    strict = _small_vae_trainer(make_mesh(devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="shrinking the mesh to 2x1"):
        strict.train_step(score)
    monkeypatch.delenv("INPAINTNET_STRICT_MESH")
    tr = _small_vae_trainer(make_mesh(devices=["cpu"] * 4))
    rows, loss_and_metrics = [], tr.loss_and_metrics
    tr.loss_and_metrics = lambda p, b, train, **kw: (rows.append(b.shape[0])
                                                     or loss_and_metrics(p, b, train, **kw))
    with pytest.warns(UserWarning, match=r"batch size 6 does not divide the 4-way data axis; "
                      r"shrinking the mesh to 2x1 — 2 device\(s\) will idle"):
        loss, _ = tr.train_step(score)
    assert tr.mesh.shape["data"] == 2 and rows == [3, 3] and np.isfinite(float(loss))


def test_trainer_rejects_another_device():
    with pytest.raises(ValueError, match="names its own device"):
        worker.vae_run(mesh=make_mesh(devices=["meta", "meta"]))


@pytest.fixture(scope="module")
def port_model():
    return build_flagship(vocab_size=30, hidden=16, z_dim=8, emb=6, seed=0, device="cpu")[2]


def _reqs():
    rng = np.random.default_rng(4)
    return [{"tokens": rng.integers(0, 30, (b, 16, 24)), "start_measure": s,
             "num_measures": n, "seed": seed}
            for b, s, n, seed in ((2, 6, 4, 1), (1, 8, 2, 2), (3, 5, 3, None))]


@pytest.mark.parametrize("named", [2, 4])
def test_engine_mesh_hetero_equals_single_device(port_model, named):
    """Per-row keys shard with their rows: the mesh engine's
    ``inpaint_hetero`` equals the engine without a mesh, bit for bit
    (the JAX package's ``test_hetero_mesh_equals_single_device``)."""
    single = InpaintingEngine(port_model, batch_buckets=(8,), dtype="float32")
    sharded = InpaintingEngine(port_model, batch_buckets=(8,), dtype="float32",
                               mesh=make_mesh(devices=["cpu"] * named))
    for x, y in zip(single.inpaint_hetero(_reqs()), sharded.inpaint_hetero(_reqs())):
        np.testing.assert_array_equal(x, y)


def test_engine_mesh_batch_seed_paths_fold_the_shard(port_model):
    """``inpaint`` and ``inpaint_variations`` on a mesh: each shard draws
    from the seed folded with its index, so the result is seeded (the same
    call twice is equal) and its span holds valid tokens."""
    engine = InpaintingEngine(port_model, batch_buckets=(4,), dtype="float32",
                              mesh=make_mesh(devices=["cpu"] * 2))
    tokens = np.random.default_rng(5).integers(0, 30, (4, 16, 24))
    a, b = engine.inpaint(tokens, 6, 4, seed=3), engine.inpaint(tokens, 6, 4, seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :6], tokens[:, :6])
    v = engine.inpaint_variations(tokens, 6, 4, num_variations=2, seed=3)
    assert v.shape == (2, 4, 16, 24) and (v >= 0).all() and (v < 30).all()
    np.testing.assert_array_equal(v, engine.inpaint_variations(tokens, 6, 4, 2, seed=3))


def test_engine_mesh_rejects_an_indivisible_bucket(port_model):
    with pytest.raises(ValueError, match=r"batch buckets \[1, 3\] do not divide"):
        InpaintingEngine(port_model, batch_buckets=(1, 3, 4), dtype="float32",
                         mesh=make_mesh(devices=["cpu"] * 2))

