"""The multi-device dry run (``__graft_entry__.py``'s
``_check_latent_rnn_tp``, ``_check_trainer_matrix`` and
``_dryrun_multichip_impl``).

    torchrun --nproc_per_node N -m inpaintnet_tpu_torch.parallel.dryrun [--device cpu]

On N processes the mesh is (N / 2, 2) when N is even and at least 4, else
(N, 1), as the JAX package's. The run takes a full LatentRNN train step
(loss, gradients, ``torch.optim.Adam``) with :func:`shard_params` applied
to the LatentRNN's parameters and the frozen VAE's and the batch over
"data", at a small geometry and at the flagship one (whose 1,536-wide gate
matrices split over "model"); then one step of each trainer (VAE,
LatentRNN, both ARNNs) on the mesh, with a validation step of each, and a
mesh ``inpaint_hetero`` call held bit-equal to the engine without a mesh.

The step gathers on use: the kernels (K1-K8) take whole weight sets, so a
step gathers the trained blocks anew (they change every step) and the
frozen VAE once, which it keeps (the kernels' weight caches, keyed by
tensor, keep hitting). Adam's moments live beside each rank's own blocks.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from inpaintnet_tpu_torch.models.base import cast_params, flatten_params, iter_leaves
from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
from inpaintnet_tpu_torch.models.measure_vae import NUM_TICKS_PER_MEASURE, MeasureVAE
from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
from inpaintnet_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedLeaf,
    all_reduce_mean,
    fold_seed,
    gate_bytes,
    gather_params,
    make_mesh,
    process_count,
    process_index,
    shard_params,
    trainable_leaves,
)
from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss
from inpaintnet_tpu_torch.train.trainer import trainable_copy

SMALL = {"hidden": 128, "z_dim": 64, "vocab": 32, "emb": 8}
FLAGSHIP = {"hidden": 512, "z_dim": 256, "vocab": 60, "emb": 10}


def model_axis(n: int) -> int:
    """The "model" axis of an ``n``-device dry run: 2 when it divides and
    ``n`` is at least 4, else 1."""
    return 2 if n % 2 == 0 and n >= 4 else 1


def example_batch(batch: int = 8, n_bars: int = 16, max_target: int = 6, vocab: int = 60,
                  seed: int = 0) -> tuple:
    """The dry run's batch (``__graft_entry__._example_batch``): 5 past, 4
    target and 7 future measures of random tokens in padded buffers. ->
    numpy (past, past_mask, future, future_mask, target, target_mask)"""
    rng = np.random.RandomState(seed)
    n_past, n_target = 5, 4
    n_future = n_bars - n_past - n_target
    past = np.zeros((batch, n_bars, 24), np.int32)
    future = np.zeros((batch, n_bars, 24), np.int32)
    target = np.zeros((batch, max_target, 24), np.int32)
    past[:, :n_past] = rng.randint(0, vocab, (batch, n_past, 24))
    future[:, :n_future] = rng.randint(0, vocab, (batch, n_future, 24))
    target[:, :n_target] = rng.randint(0, vocab, (batch, n_target, 24))
    pm = (np.arange(n_bars) < n_past)[None].repeat(batch, 0).astype(np.float32)
    fm = (np.arange(n_bars) < n_future)[None].repeat(batch, 0).astype(np.float32)
    tm = (np.arange(max_target) < n_target)[None].repeat(batch, 0).astype(np.float32)
    return past, pm, future, fm, target, tm


def build_models(hidden: int, z_dim: int, vocab: int, emb: int, *, seed: int = 0,
                 device="cuda", dropout: float = 0.5):
    """A 2-layer MeasureVAE and LatentRNN of the geometry, random weights
    from ``seed`` (the LatentRNN's from ``seed + 1``); ``dropout`` is the
    LatentRNN's and the VAE encoder's. -> (vae, latent_rnn)"""
    vae = MeasureVAE(VocabOnlyDataset(vocab), note_embedding_dim=emb, num_encoder_layers=2,
                     encoder_hidden_size=hidden, latent_space_dim=z_dim, num_decoder_layers=2,
                     decoder_hidden_size=hidden, encoder_dropout_prob=dropout, device=device,
                     seed=seed)
    return vae, LatentRNN(vae, 2, hidden, device=device, dropout=dropout, seed=seed + 1)


def _step_device(mesh: Mesh) -> torch.device:
    device = mesh.device_of(mesh.local_indices()[0])
    if not all(d == device for d in mesh.devices):
        raise ValueError(f"{mesh}: a step runs its shards on one device")
    return device


def sharded_vae_forward(mesh: Mesh, vae: MeasureVAE, tokens: torch.Tensor, *,
                        dtype: torch.dtype = torch.float32, eps: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """``vae.apply(train=False)`` on this process's rows with the VAE's
    parameters placed by :func:`shard_params` (in ``dtype``) and gathered
    on use (the JAX package's ``test_tensor_parallel_sharding_matches``).
    -> (the apply's outputs, the sharded parameters)"""
    params = shard_params(mesh, cast_params(vae.params(), _step_device(mesh), dtype))[0]
    with torch.no_grad():
        out = vae.apply(gather_params(params), tokens, train=False, eps=eps,
                        generator=generator)
    return out, params


class ShardedLatentRNNStep:
    """A full LatentRNN train step on a (data, model) mesh: the JAX
    package's ``_check_latent_rnn_tp``. The LatentRNN's gate matrices are
    :class:`ShardedLeaf` blocks an Adam owns (its moments beside them); the
    frozen VAE is placed alike and gathered once. Each step draws a seed
    from ``seed``'s CPU stream and each data shard folds its data index into
    it for its dropout masks and rsample noise, so model peers draw the
    same. The loss is the cross-entropy over the target measures' ticks; the
    gradients, loss and accuracy are averaged over the data group."""

    def __init__(self, mesh: Mesh, model: LatentRNN, lr: float = 1e-4, seed: int = 0):
        self.mesh, self.model = mesh, model
        self.device = _step_device(mesh)
        self.params = shard_params(mesh, trainable_copy(model.params(), self.device))[0]
        self.vae_sharded = shard_params(
            mesh, cast_params(model.vae_model.params(), self.device, torch.float32))[0]
        with torch.no_grad():
            self.vae_params = gather_params(self.vae_sharded)
        self.optimizer = torch.optim.Adam(trainable_leaves(self.params), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.coin_generator = torch.Generator().manual_seed(seed)

    def loss(self, params, batch, generator, eps=None):
        """(loss, accuracy) of ``batch`` (device tensors) under ``params``."""
        past, pm, future, fm, target, tm = batch
        weights, _, _ = self.model.apply(
            params, self.vae_params, past, future, target, past_mask=pm, future_mask=fm,
            target_mask=tm, train=True, generator=generator, eps=eps)
        tick_mask = tm[:, :, None].expand(-1, -1, NUM_TICKS_PER_MEASURE)
        return (mean_crossentropy_loss(weights, target, mask=tick_mask),
                mean_accuracy(weights, target, mask=tick_mask))


    def step(self, batch, eps: Optional[torch.Tensor] = None):
        """One Adam step on the global ``batch`` (this process keeps its data
        index's rows). ``eps``: optional (B, past + future measures, z)
        rsample noise of the global rows. -> (loss, accuracy) tensors"""
        batch = tuple(torch.as_tensor(x).to(self.device) for x in batch)
        rows, data = batch[0].shape[0], self.mesh.shape["data"]
        if rows % data:
            raise ValueError(f"batch {rows} does not divide the {data}-way data axis")
        per = rows // data
        self.optimizer.zero_grad(set_to_none=True)
        step_seed = int(torch.randint(0, 2**62, (), generator=self.coin_generator))
        local = self.mesh.local_indices()
        losses, accs = [], []
        for i in local:
            lo, hi = i * per, (i + 1) * per
            generator = torch.Generator(device=self.device).manual_seed(fold_seed(step_seed, i))
            shard_eps = None if eps is None else eps[lo:hi].reshape(-1, eps.shape[-1]).to(
                self.device)
            loss, acc = self.loss(gather_params(self.params), tuple(x[lo:hi] for x in batch),
                                  generator, shard_eps)
            (loss / len(local)).backward()
            losses.append(loss.detach().float())
            accs.append(acc.detach().float())
        leaves = trainable_leaves(self.params)
        for p in leaves:  # every rank reduces the same buffer
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss, acc = torch.stack(losses).mean(), torch.stack(accs).mean()
        if self.mesh.distributed:
            all_reduce_mean([p.grad for p in leaves] + [loss, acc], self.mesh.data_group)
        self.optimizer.step()
        return loss, acc

    def full_params(self) -> dict:
        """{path: whole parameter} as numpy (a collective on a world mesh)."""
        with torch.no_grad():
            return flatten_params(gather_params(self.params))

    def save(self, path: str) -> None:
        """The LatentRNN's checkpoint: the blocks gathered (every rank
        calls this), then rank 0 writes the file one process would."""
        with torch.no_grad():
            full = gather_params(self.params)
        if process_index() == 0:
            self.model.set_params(full)
            self.model.save(path)

    def gate_bytes(self) -> dict:
        """Bytes of the gate matrices this process holds against their whole
        size: the LatentRNN's, the frozen VAE's, and the LatentRNN's Adam
        moments."""
        moments = whole = 0
        for _, leaf in iter_leaves(self.params):
            if isinstance(leaf, ShardedLeaf):
                whole += 2 * leaf.nbytes * leaf.count // len(leaf.blocks)
                for block in leaf.blocks:
                    state = self.optimizer.state.get(block, {})
                    moments += sum(state[k].numel() * state[k].element_size()
                                   for k in ("exp_avg", "exp_avg_sq") if k in state)
        return {"latent_rnn": gate_bytes(self.params), "vae": gate_bytes(self.vae_sharded),
                "adam_moments": (moments, whole)}


def check_latent_rnn_tp(mesh: Mesh, geometry: dict, batch: int, steps: int = 2,
                        device="cuda") -> dict:
    """``steps`` sharded LatentRNN steps at ``geometry`` on a ``batch``-row
    global batch. -> {"losses", "step_ms" (the last step's wall), "bytes"}"""
    _, model = build_models(**geometry, device=device)
    step = ShardedLatentRNNStep(mesh, model)
    data = example_batch(batch, vocab=geometry["vocab"])
    losses, wall = [], None
    for _ in range(steps):
        _sync(step.device)
        t0 = time.perf_counter()
        loss, _ = step.step(data)
        losses.append(loss.item())
        wall = (time.perf_counter() - t0) * 1e3
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite tensor-parallel loss {losses}")
    return {"losses": losses, "step_ms": wall, "bytes": step.gate_bytes()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_trainer_matrix(mesh: Mesh, device, workdir: str) -> list:
    """One train step and one validation step of each trainer (VAE,
    LatentRNN, ARNN reg, ARNN baseline) on ``mesh`` over a tiny synthetic
    corpus (``__graft_entry__._check_trainer_matrix``'s), then a mesh ``inpaint_hetero`` call held bit-equal to the engine
    without a mesh (a local (data, model) mesh naming ``device``: the engine
    shards over a local mesh). -> [(name, loss)]"""
    from inpaintnet_tpu_torch.data import BeatMarkerMetadata, DatasetManager, TickMetadata
    from inpaintnet_tpu_torch.data.synthetic import generate_corpus
    from inpaintnet_tpu_torch.models import ConstraintModelGaussianReg, AnticipationRNNBaseline
    from inpaintnet_tpu_torch.serve import InpaintingEngine
    from inpaintnet_tpu_torch.train import (
        AnticipationRNNBaselineTrainer,
        AnticipationRNNGaussianRegTrainer,
        LatentRNNTrainer,
        VAETrainer,
    )

    data_axis = mesh.shape["data"]
    corpus = os.path.join(workdir, "corpus")
    generate_corpus(corpus, num_tunes=10, num_bars=16, seed=7)
    ds = DatasetManager(cache_dir=os.path.join(workdir, "cache"), corpus_dir=corpus).get_dataset(
        "folk_4by4nbars_short", metadatas=[BeatMarkerMetadata(6), TickMetadata(6)],
        num_bars=16, train=True)
    loader, _, _ = ds.data_loaders(batch_size=2 * data_axis, split=(0.7, 0.2))
    one_batch = [next(iter(loader))]
    vae = MeasureVAE(ds, note_embedding_dim=8, num_encoder_layers=1, encoder_hidden_size=16,
                     latent_space_dim=12, num_decoder_layers=1, decoder_hidden_size=16,
                     checkpoint_dir=workdir, device=device)
    lrnn = LatentRNN(vae, 2, 16, dropout=0.5, dataset=ds, checkpoint_dir=workdir,
                     device=device)
    # the ARNNs at K7's smallest geometry (2 layers of 64 units), so their
    # validation runs K7 on a card; the JAX package's matrix has 1 layer of 16
    arnn_kw = dict(note_embedding_dim=8, metadata_embedding_dim=4,
                   num_lstm_constraints_units=64, num_lstm_generation_units=64,
                   linear_hidden_size=64, num_layers=2, unary_constraint=True,
                   checkpoint_dir=workdir, device=device)
    kw = dict(lr=1e-3, mesh=mesh, device=device)
    trainers = [
        ("vae", VAETrainer(ds, vae, **kw)),
        ("latent_rnn", LatentRNNTrainer(ds, lrnn, **kw)),
        ("arnn_reg", AnticipationRNNGaussianRegTrainer(
            ds, ConstraintModelGaussianReg(ds, **arnn_kw), **kw)),
        ("arnn_baseline", AnticipationRNNBaselineTrainer(
            ds, AnticipationRNNBaseline(ds, **arnn_kw), **kw)),
    ]
    results = []
    for name, tr in trainers:
        for train in (True, False):
            loss, _ = tr.loss_and_acc_on_epoch(one_batch, train=train)
            if not np.isfinite(loss):
                raise RuntimeError(f"{name} trainer: non-finite loss")
            results.append((f"{name}_trainer_{'train' if train else 'validation'}", loss))
    bucket = max(8, data_axis)
    solo = InpaintingEngine(lrnn, batch_buckets=(bucket,), dtype="float32", device=device)
    local = make_mesh(data=data_axis, model=mesh.shape["model"],
                      devices=[device] * (data_axis * mesh.shape["model"]))
    over_mesh = InpaintingEngine(lrnn, batch_buckets=(bucket,), dtype="float32", mesh=local)
    vocab = lrnn.vae_model.num_notes
    rng = np.random.RandomState(3)
    reqs = [{"tokens": rng.randint(0, vocab, (2, 16, 24)), "start_measure": 4,
             "num_measures": 3, "seed": 11},
            {"tokens": rng.randint(0, vocab, (1, 16, 24)), "start_measure": 2,
             "num_measures": 2, "seed": 5}]
    for a, b in zip(solo.inpaint_hetero([dict(r) for r in reqs]),
                    over_mesh.inpaint_hetero([dict(r) for r in reqs])):
        if not np.array_equal(a, b):
            raise RuntimeError("the mesh engine's inpaint_hetero differs from the engine's")
    results.append(("serving_hetero_parity", 0.0))
    return results


def run(device, batch: Optional[int] = None, steps: int = 2,
        trainer_matrix: bool = True) -> dict:
    """The dry run on this process's group (or alone): -> its results."""
    n = process_count()
    mesh = (make_mesh(model=model_axis(n)) if n > 1
            else make_mesh(devices=[device]))
    out = {"mesh": dict(mesh.shape), "processes": n}
    for name, geometry in (("small", SMALL), ("flagship", FLAGSHIP)):
        rows = batch or 2 * (n if name == "small" else mesh.shape["data"])
        out[name] = check_latent_rnn_tp(mesh, geometry, rows, steps, device)
        out[name]["batch"] = rows
    if trainer_matrix:
        with tempfile.TemporaryDirectory() as workdir:
            out["trainer_matrix"] = check_trainer_matrix(mesh, device, workdir)
    return out


def main(argv=None) -> int:
    from inpaintnet_tpu_torch.cli.common import train_device

    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--device", default="cuda")
    cli.add_argument("--batch", type=int, default=None,
                     help="global rows of each LatentRNN step (default: 2 a process at the "
                          "small geometry, 2 a data index at the flagship one)")
    cli.add_argument("--steps", type=int, default=2)
    cli.add_argument("--no_trainer_matrix", action="store_true")
    args = cli.parse_args(argv)
    device = train_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    out = run(device, args.batch, args.steps, not args.no_trainer_matrix)
    rank = process_index()
    for name in ("small", "flagship"):
        r = out[name]
        held, whole = r["bytes"]["latent_rnn"]
        print(f"rank {rank}: latent_rnn_tp_{name} batch {r['batch']} losses {r['losses']} "
              f"step {r['step_ms']:.2f} ms, gate bytes {held} of {whole}, "
              f"vae {r['bytes']['vae'][0]} of {r['bytes']['vae'][1]}, "
              f"adam moments {r['bytes']['adam_moments'][0]} of "
              f"{r['bytes']['adam_moments'][1]}", flush=True)
    if rank == 0:
        for name, loss in out.get("trainer_matrix", []):
            print(f"subcheck {name} ok (loss={loss:.4f})")
        print(f"dryrun ok: mesh={out['mesh']} processes={out['processes']} "
              f"tp_loss={out['small']['losses'][0]:.4f} "
              f"flagship_tp_loss={out['flagship']['losses'][0]:.4f}", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
