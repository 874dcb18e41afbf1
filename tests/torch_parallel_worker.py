"""The port's VAE trainer, run the same way in one process or in each rank
of a ``torch.distributed`` gloo group (``tests/test_torch_parallel.py``;
``chip_smoke.py`` has its own copy on the card), and the tensor-parallel
runs of ``tests/test_torch_tensor_parallel.py``."""
import numpy as np
import torch
import torch.distributed as dist

from inpaintnet_tpu_torch.models.base import flatten_params
from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
from inpaintnet_tpu_torch.train.data import ArrayDataset
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

V, H, Z, N_BARS = 30, 16, 8, 2
WINDOWS = 6  # a step's global batch: 12 measure rows
TAIL_ROWS = 7  # an eval tail two ranks do not divide
STEPS = 3


def vae_run(seed: int = 0, mesh=None):
    """Three Adam steps (lr 1e-3, dropout 0, the rsample noise and coin
    injected) on the same global batches, then an eval step on a 7-row
    tail. -> ({path: parameter}, tail loss, tail accuracy, the rows of each
    loss this process computed)"""
    rng = np.random.default_rng(seed)
    windows = rng.integers(0, V, (STEPS * WINDOWS, 1, N_BARS * 24)).astype(np.int32)
    ds = ArrayDataset([windows], N_BARS)
    model = MeasureVAE(VocabOnlyDataset(V), note_embedding_dim=6, encoder_hidden_size=H,
                       latent_space_dim=Z, decoder_hidden_size=H, encoder_dropout_prob=0.0,
                       decoder_dropout_prob=0.0, device="cpu", seed=seed)
    trainer = VAETrainer(ds, model, lr=1e-3, device="cpu", mesh=mesh)
    rows, loss_and_metrics = [], trainer.loss_and_metrics

    def recorded(params, batch_data, train, **kw):
        rows.append(batch_data.shape[0])
        return loss_and_metrics(params, batch_data, train, **kw)

    trainer.loss_and_metrics = recorded
    for step in range(STEPS):
        batch = trainer.process_batch_data((windows[step * WINDOWS:(step + 1) * WINDOWS],))
        eps = torch.from_numpy(rng.standard_normal((batch.shape[0], Z)).astype(np.float32))
        trainer.train_step(batch, eps=eps, coin=bool(step % 2))
    tail = torch.from_numpy(rng.integers(0, V, (TAIL_ROWS, 24)).astype(np.int32))
    eps = torch.from_numpy(rng.standard_normal((TAIL_ROWS, Z)).astype(np.float32))
    loss, metrics = trainer.eval_step(tail, eps=eps)
    return flatten_params(trainer.params), float(loss), float(metrics["accuracy"]), rows


def rank_main(rank: int, world: int, port: int, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        params, loss, acc, rows = vae_run()
        if rank == 0:
            np.savez(out_path, loss=loss, acc=acc, rows=rows, **params)
    finally:
        dist.destroy_process_group()


def cli_rank_main(rank: int, world: int, port: int, out_path: str) -> None:
    """A rank as ``torchrun`` starts one: the environment names the group;
    ``resolve_device`` (every entry point's) joins nothing, the trainers'
    ``train_device("cpu")`` joins it (gloo)."""
    import os

    from inpaintnet_tpu_torch.cli.common import resolve_device, train_device
    from inpaintnet_tpu_torch.parallel.mesh import all_reduce_mean, process_count

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    assert resolve_device("cpu") == torch.device("cpu") and not dist.is_initialized()
    device = train_device("cpu")
    try:
        x = torch.tensor([float(rank)])
        all_reduce_mean([x])
        if rank == 0:
            np.savez(out_path, backend=dist.get_backend(), world=process_count(),
                     mean=x.numpy(), device=str(device))
    finally:
        dist.destroy_process_group()


# --- tensor parallelism (tests/test_torch_tensor_parallel.py) ---------------- #
TP_BATCH = 4  # the LatentRNN steps' global rows
TP_STEPS = 3


def tp_latent_run(mesh, dropout: float, eps=None, save=None) -> dict:
    """``TP_STEPS`` dry-run LatentRNN steps at the small geometry on
    ``mesh``; with ``eps`` ((steps, B, measures, z)) each step's rsample
    noise injected. -> {"params": {path: whole parameter}, "losses",
    "bytes"}; with ``save``, the checkpoint written there."""
    from inpaintnet_tpu_torch.parallel import dryrun

    _, model = dryrun.build_models(**dryrun.SMALL, device="cpu", dropout=dropout)
    step = dryrun.ShardedLatentRNNStep(mesh, model)
    batch = dryrun.example_batch(TP_BATCH, vocab=dryrun.SMALL["vocab"])
    losses = [float(step.step(batch, eps=None if eps is None else torch.from_numpy(eps[s]))[0])
              for s in range(TP_STEPS)]
    out = {"params": step.full_params(), "losses": losses, "bytes": step.gate_bytes()}
    if save is not None:
        step.save(save)
    return out


def tp_eps(seed: int = 5) -> np.ndarray:
    """Rsample noise of every step's global rows, (steps, B, 32, z)."""
    from inpaintnet_tpu_torch.parallel import dryrun

    rng = np.random.default_rng(seed)
    return rng.standard_normal((TP_STEPS, TP_BATCH, 32, dryrun.SMALL["z_dim"])).astype(
        np.float32)


def tp_vae_forward(mesh, inputs: dict):
    """The sharded MeasureVAE forward of ``inputs`` (its parameters, tokens
    and noise). -> (weights, samples, the sharded parameters)"""
    from inpaintnet_tpu_torch.models.base import unflatten_params
    from inpaintnet_tpu_torch.parallel import dryrun

    vae = MeasureVAE(VocabOnlyDataset(int(inputs["vocab"])), note_embedding_dim=8,
                     num_encoder_layers=2, encoder_hidden_size=128, latent_space_dim=12,
                     num_decoder_layers=1, decoder_hidden_size=128, encoder_dropout_prob=0.0,
                     decoder_dropout_prob=0.0, device="cpu")
    vae.set_params(unflatten_params({k[2:]: v for k, v in inputs.items()
                                     if k.startswith("p/")}))
    (weights, samples, *_), params = dryrun.sharded_vae_forward(
        mesh, vae, torch.from_numpy(inputs["tokens"]), eps=torch.from_numpy(inputs["eps"]))
    return weights.numpy(), samples.numpy(), params


def tp_rank_main(rank: int, world: int, port: int, model: int, in_path: str,
                 out_dir: str) -> None:
    """A rank of a ``world / model`` x ``model`` gloo world: its indices and
    groups' sizes, the sharded VAE forward, the gate bytes it holds, and the
    LatentRNN runs (with ``model == world`` also the one at dropout 0.5,
    whose draws match one process's); rank 0 of a 2-D world writes the
    checkpoint. Each rank saves ``rank<r>.npz`` in ``out_dir``."""
    import os

    from inpaintnet_tpu_torch.parallel.mesh import gate_bytes, make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(model=model)
        with np.load(in_path) as z:
            inputs = {k: z[k] for k in z.files}
        weights, samples, vae_params = tp_vae_forward(mesh, inputs)
        out = {"data_index": mesh.local_indices()[0], "model_index": mesh.model_indices()[0],
               "model_group": dist.get_world_size(mesh.model_group),
               "data_group": dist.get_world_size(mesh.data_group),
               "weights": weights, "samples": samples,
               "vae_bytes": np.asarray(gate_bytes(vae_params))}
        ckpt = os.path.join(out_dir, "ckpt.npz") if model < world else None
        injected = tp_latent_run(mesh, 0.0, tp_eps(), save=ckpt)
        out.update({f"eps/{k}": v for k, v in injected["params"].items()})
        out["eps_losses"] = injected["losses"]
        for name, (held, whole) in injected["bytes"].items():
            out[f"bytes/{name}"] = np.asarray([held, whole])
        if model == world:
            drawn = tp_latent_run(mesh, 0.5)
            out.update({f"drawn/{k}": v for k, v in drawn["params"].items()})
            out["drawn_losses"] = drawn["losses"]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
