"""The port's VAE trainer, run the same way in one process or in each rank
of a ``torch.distributed`` gloo group (``tests/test_torch_parallel.py``;
``chip_smoke.py`` has its own copy on the card)."""
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
