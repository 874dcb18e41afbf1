"""The trainer base class on one device (``inpaintnet_tpu/train/trainer.py``).

``Trainer(dataset, model, lr, early_stopping)`` and ``train_model(batch_size,
num_epochs, split, run_name)``: per-epoch train and validation passes, a
JSONL metrics log, a model save every epoch, a numbered checkpoint every
10 epochs, optional early stopping, and ``save_state``/``load_state`` of
parameters, Adam moments and the epoch count for a true resume.

Subclasses implement ``process_batch_data`` (a loader batch -> device
tensors) and ``loss_and_metrics(params, batch_data, train, **inject)`` ->
(scalar loss, {"accuracy": scalar}). The trainer holds f32 master
parameters in the JAX package's nested (in, out) layout and a
``torch.optim.Adam`` over them with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8). With ``compute_dtype="bfloat16"`` the parameters are cast inside
the loss (activations follow); masters and Adam state stay f32.

A subclass whose loss reads frozen parameters beside the trained ones (the
LatentRNN's MeasureVAE) returns them from ``extra_params``: the trainer
keeps one copy, detached, on its device, in the compute dtype, made once
(so the kernels' weight caches hold across steps), passes it to the loss
as ``extra=`` and never optimises it.

Randomness is explicit: ``generator``, a seeded ``torch.Generator`` on the
trainer's device, draws dropout masks and rsample noise; ``coin_generator``,
a seeded CPU generator, draws the per-batch teacher-forcing coin on the
host.

Data parallelism (``mesh=``, ``parallel/mesh.py``): the default mesh is
the world of the ``torch.distributed`` group where one is initialised (a
rank a data index, each on its own device: ``torchrun``), else the
trainer's one device. With a data axis D above 1, every rank reads the
same loader order and processes the same global batch, then keeps its rows
(data index i: rows [i n / D, (i + 1) n / D); a local mesh that names the
trainer's device D times runs its D shards in turn). Each shard's loss is
its rows' mean; the loss, the metrics and the gradients are averaged over
the shards (``all_reduce`` over the mesh's data group: the ranks of one
model index): equal shards, so that is the global batch's mean. A (data,
model) mesh replicates the parameters, as the JAX package's trainer does
(it never calls ``shard_params``): model peers compute the same shard with
the same noise, so their gradients already agree. Randomness follows the
JAX trainer's kernel-bearing path (``grads_per_shard``,
``inpaintnet_tpu/train/trainer.py:295-315``): each
step draws one seed from ``coin_generator`` (every rank the same) and each
shard folds its data index into it for its own dropout masks, rsample noise
and teacher-forcing coin, so a shard's noise depends on its index alone
and each shard flips its own coin. Injected draws (a test's ``eps=``, ...)
whose rows lead are split with the batch. A train batch that the data axis
does not divide raises with several processes; in one process the data
axis shrinks to the largest divisor, with the JAX trainer's warning (its
error under ``INPAINTNET_STRICT_MESH=1``). An eval tail is padded to
the data axis (``pad_rows_to_divisible``) and its pad rows masked out of
the loss (``loss_and_metrics(row_mask=)``, whose metrics then carry the
``weight`` of the masked mean), so its mean equals one process's. Only
rank 0 writes checkpoints, metrics and plots. With ``debug=True`` the
parameters are swept for NaN and infinity once an epoch (``utils/debug.py
nan_check``).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
import warnings
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from inpaintnet_tpu_torch.models.base import cast_params, iter_leaves
from inpaintnet_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    fold_seed,
    make_mesh,
    pad_leading,
    pad_rows_to_divisible,
    process_count,
    process_index,
    take_rows,
)
from inpaintnet_tpu_torch.train.checkpoints import load_train_state, save_train_state


class EarlyStopping:
    """Patience-5 early stopping (reference utils/trainer.py:379-413),
    including its detail that an improvement below 1e-5 still counts
    toward the patience."""

    def __init__(self, patience: int = 5):
        self.patience = patience
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = np.inf

    def __call__(self, val_loss: float) -> None:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
        elif score <= self.best_score or score - self.best_score < 1e-5:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.val_loss_min = val_loss
            self.counter = 0


def batch_rows(batch_data) -> int:
    """The rows of a batch: its first tensor's leading dimension."""
    return next(leaf for _, leaf in iter_leaves(batch_data)
                if isinstance(leaf, (torch.Tensor, np.ndarray))).shape[0]


def trainable_copy(tree, device: torch.device):
    """f32 copies of nested parameters on ``device`` that require grad."""
    if isinstance(tree, dict):
        return {k: trainable_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [trainable_copy(v, device) for v in tree]
    t = torch.as_tensor(tree).detach().to(device=device, dtype=torch.float32, copy=True)
    return t.contiguous().requires_grad_(True)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class Trainer(ABC):
    def __init__(self, dataset, model, lr: float = 1e-4, early_stopping: bool = False,
                 seed: int = 0, compute_dtype: Optional[str] = None, device="cuda",
                 mesh: Optional[Mesh] = None, debug: bool = False):
        self.dataset = dataset
        self.model = model
        self.lr = lr
        self.seed = seed
        self.device = torch.device(device)
        if mesh is None:
            mesh = (Mesh([self.device], process_count(), distributed=True)
                    if process_count() > 1 else make_mesh(devices=[self.device]))
        if not all(_same_device(d, self.device) for d in mesh.devices):
            raise ValueError(f"the trainer on {self.device} cannot take {mesh}: a mesh of a "
                             "trainer names its own device (a rank's, in a world mesh)")
        self.mesh = mesh
        self.debug = debug
        if compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: None (f32) or 'bfloat16'")
        self.compute_dtype = compute_dtype
        self.params = trainable_copy(self.trainable_params(model.params()), self.device)
        extra = self.extra_params()
        self.extra = None if extra is None else cast_params(
            extra, self.device, getattr(torch, compute_dtype or "float32"))
        self.optimizer = torch.optim.Adam([p for _, p in iter_leaves(self.params)], lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.coin_generator = torch.Generator().manual_seed(seed)
        self.early_stopper = EarlyStopping() if early_stopping else None
        self.epoch = 0  # completed epochs

    # --- subclass surface -------------------------------------------------- #
    @abstractmethod
    def process_batch_data(self, batch):
        """A loader batch -> the tensors ``loss_and_metrics`` takes."""

    @abstractmethod
    def loss_and_metrics(self, params, batch_data, train: bool, **inject):
        """(scalar loss, {"accuracy": scalar}); with ``extra_params``, the
        frozen parameters come as ``extra=``."""

    def extra_params(self):
        """Frozen nested parameters the loss reads, or None."""
        return None

    def update_scheduler(self, epoch_num: int) -> None:
        """Learning-rate schedule hook, called at the start of each epoch (a
        no-op, as the reference's ``vae_trainer.py:57-63``)."""

    def trainable_params(self, params):
        """The part of the model's parameters the optimiser owns (all of
        them: a frozen model comes through :meth:`extra_params`)."""
        return params

    def merge_params(self, params, trained):
        """Inverse of :meth:`trainable_params`: the model's parameters with
        ``trained`` in place."""
        return trained

    def default_train_gru_impl(self):
        """The family's training GRU route: None. The JAX package picks a
        route per trainer family; the port picks one per layer from its
        width (``ops/gru_train_kernel.trainfast_supports``), so a family
        default has nothing to choose."""
        return None

    # --- steps ------------------------------------------------------------- #
    def compute_params(self):
        """The parameters the loss sees: the masters, or their cast to the
        compute dtype (differentiable, so gradients reach the masters)."""
        if self.compute_dtype is None:
            return self.params
        return cast_params(self.params, self.device, getattr(torch, self.compute_dtype))

    def _loss(self, batch_data, train: bool, inject: dict):
        if self.extra is not None:
            inject = {**inject, "extra": self.extra}
        return self.loss_and_metrics(self.compute_params(), batch_data, train, **inject)

    @property
    def is_writer(self) -> bool:
        """Only rank 0 writes checkpoints, metrics and plots."""
        return process_index() == 0

    def _data_axis(self) -> int:
        return self.mesh.shape["data"]

    def _one_shard(self) -> bool:
        """A step without shards: one local device (a world mesh of one
        rank still reduces over its group)."""
        return self._data_axis() == 1 and not self.mesh.distributed

    @contextlib.contextmanager
    def _shard_noise(self, step_seed: int, index: int):
        """The generators of data index ``index`` for one step: its dropout
        masks, rsample noise and coin come from ``step_seed`` folded with
        its index."""
        saved = self.generator, self.coin_generator
        seed = fold_seed(step_seed, index)
        self.generator = torch.Generator(device=saved[0].device).manual_seed(seed)
        self.coin_generator = torch.Generator().manual_seed(fold_seed(seed, 1))
        try:
            yield
        finally:
            self.generator, self.coin_generator = saved

    def _shards(self, batch_data, inject: dict):
        """(data index, rows, inject) of this process's shards of a global
        batch whose rows the data axis divides."""
        rows = batch_rows(batch_data)
        per = rows // self._data_axis()
        for i in self.mesh.local_indices():
            lo, hi = i * per, (i + 1) * per
            yield i, take_rows(batch_data, lo, hi, rows), take_rows(inject, lo, hi, rows)

    def train_step(self, batch_data, **inject):
        """One Adam step; -> (loss, metrics) as device tensors."""
        self.optimizer.zero_grad(set_to_none=True)
        if self._one_shard():
            loss, metrics = self._loss(batch_data, True, inject)
            loss.backward()
        else:
            rows = batch_rows(batch_data)
            if rows % self._data_axis():
                self._fit_mesh_to_batch_size(rows)
            loss, metrics = self._sharded_grads(batch_data, inject)
        self.optimizer.step()
        return loss.detach(), metrics

    def _fit_mesh_to_batch_size(self, rows: int) -> None:
        """Shrink the data axis to gcd(rows, D) for a batch it does not
        divide, keeping the model axis, as the JAX package's trainer does
        (``inpaintnet_tpu/train/trainer.py:188-223``): a small batch still
        runs, with a warning (an error under ``INPAINTNET_STRICT_MESH=1``).
        With several processes it raises: every rank holds one shard of a
        fixed world."""
        data_axis, model_axis = self._data_axis(), self.mesh.shape["model"]
        if process_count() > 1:
            raise ValueError(f"global batch {rows} ({process_count()} processes) must divide "
                             f"the {data_axis}-way data axis in a multi-host run")
        new_data = math.gcd(rows, data_axis)
        msg = (f"batch size {rows} does not divide the {data_axis}-way data axis; shrinking "
               f"the mesh to {new_data}x{model_axis} — {(data_axis - new_data) * model_axis} "
               f"device(s) will idle. Pick a batch size divisible by {data_axis} to use the "
               "full mesh.")
        if os.environ.get("INPAINTNET_STRICT_MESH", "0") == "1":
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=3)
        self.mesh = make_mesh(devices=self.mesh.devices[:new_data * model_axis], data=new_data,
                              model=model_axis)

    def _sharded_grads(self, batch_data, inject: dict):
        """The gradients, loss and metrics of a global batch averaged over its
        shards: this process's in turn, then every process's."""
        step_seed = int(torch.randint(0, 2**62, (), generator=self.coin_generator))
        local = self.mesh.local_indices()
        losses, accs = [], []
        for i, shard, shard_inject in self._shards(batch_data, inject):
            with self._shard_noise(step_seed, i):
                loss, metrics = self._loss(shard, True, shard_inject)
            (loss / len(local)).backward()
            losses.append(loss.detach().float())
            accs.append(metrics["accuracy"].detach().float())
        leaves = [p for _, p in iter_leaves(self.params)]
        for p in leaves:  # every rank reduces the same buffer
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss, acc = torch.stack(losses).mean(), torch.stack(accs).mean()
        if self.mesh.distributed:
            all_reduce_mean([p.grad for p in leaves] + [loss, acc], self.mesh.data_group)
        return loss, {"accuracy": acc}

    def eval_step(self, batch_data, **inject):
        with torch.no_grad():
            if self._one_shard():
                return self._loss(batch_data, False, inject)
            return self._sharded_eval(batch_data, inject)

    def _sharded_eval(self, batch_data, inject: dict):
        """The eval loss and metrics of a global batch over the shards. A
        tail that the data axis does not divide is padded to it and its pad
        rows masked out: each shard's masked means are weighted by their
        ``weight``, so the result is the unpadded batch's mean."""
        rows = batch_rows(batch_data)
        row_mask = None
        if rows % self._data_axis():
            batch_data, mask = pad_rows_to_divisible(batch_data, self._data_axis(), 1)
            row_mask = torch.from_numpy(mask).to(self.device)
            inject = pad_leading(inject, rows, mask.shape[0])
        sums = []
        for _, (shard, shard_mask), shard_inject in self._shards((batch_data, row_mask), inject):
            extra = {} if shard_mask is None else {"row_mask": shard_mask}
            loss, metrics = self._loss(shard, False, {**shard_inject, **extra})
            weight = metrics["weight"].float() if shard_mask is not None else torch.ones(
                (), device=self.device)
            sums.append(torch.stack([loss.float() * weight,
                                     metrics["accuracy"].float() * weight, weight]))
        total = torch.stack(sums).sum(dim=0)
        if self.mesh.distributed:
            all_reduce_mean([total], self.mesh.data_group)
        return total[0] / total[2], {"accuracy": total[1] / total[2]}

    # --- epoch machinery ---------------------------------------------------- #
    def loss_and_acc_on_epoch(self, data_loader, train: bool = True):
        """Mean loss and accuracy over the loader's batches (reference
        trainer.py:126-163); one device sync, at the end."""
        losses, accs = [], []
        step = self.train_step if train else self.eval_step
        for batch in data_loader:
            loss, metrics = step(self.process_batch_data(batch))
            losses.append(loss)
            accs.append(metrics["accuracy"])
        if self.debug:
            from inpaintnet_tpu_torch.utils.debug import nan_check

            nan_check(self.params, f"{type(self.model).__name__} params")
        if not losses:
            return 0.0, 0.0
        return torch.stack(losses).mean().item(), torch.stack(accs).mean().item()

    def train_model(self, batch_size: int, num_epochs: int, split=(0.70, 0.20),
                    run_name: Optional[str] = None, log: bool = False,
                    plot: bool = False) -> None:
        """``num_epochs`` more epochs, numbered on from ``self.epoch``. With
        ``log``, ``plot`` or ``run_name``, each epoch's stats append to
        ``runs/<run_name>.jsonl``; ``plot`` also redraws the train and
        validation curves each epoch (``utils.plotting.LivePlot``: a live
        figure with a display, ``runs/<run_name>.png`` without one)."""
        metrics_path = None
        live_plot = None
        if (log or plot or run_name is not None) and self.is_writer:
            os.makedirs("runs", exist_ok=True)
            run_name = run_name or f"{type(self.model).__name__}_{int(time.time())}"
            metrics_path = os.path.join("runs", run_name + ".jsonl")
            if plot:
                from inpaintnet_tpu_torch.utils.plotting import LivePlot

                live_plot = LivePlot(os.path.join("runs", run_name + ".png"))
        try:
            self._run_epochs(batch_size, num_epochs, split, metrics_path, live_plot)
        finally:
            if live_plot is not None:
                live_plot.close()

    def _run_epochs(self, batch_size: int, num_epochs: int, split, metrics_path, live_plot):
        train_loader, val_loader, _ = self.dataset.data_loaders(
            batch_size=batch_size, split=split, seed=self.seed)
        print("Num Train Batches: ", len(train_loader))
        print("Num Valid Batches: ", len(val_loader))
        start = self.epoch
        for epoch_index in range(start, start + num_epochs):
            self.update_scheduler(epoch_index)
            t0 = time.time()
            loss_train, acc_train = self.loss_and_acc_on_epoch(train_loader, train=True)
            loss_val, acc_val = self.loss_and_acc_on_epoch(val_loader, train=False)
            self.epoch = epoch_index + 1
            stats = {"epoch_index": epoch_index, "num_epochs": start + num_epochs,
                     "mean_loss_train": loss_train, "mean_accuracy_train": acc_train,
                     "mean_loss_val": loss_val, "mean_accuracy_val": acc_val,
                     "epoch_seconds": time.time() - t0}
            if metrics_path:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(stats) + "\n")
            if live_plot is not None:
                live_plot.update(**stats)
            self.print_epoch_stats(**stats)
            self.model.set_params(self.merge_params(self.model.params(), self.params))
            if self.is_writer:
                self.model.save()
                self.save_state()
                if epoch_index > 0 and epoch_index % 10 == 0:
                    self.model.save_checkpoint(epoch_index)
            if self.early_stopper is not None:
                self.early_stopper(loss_val)
                if self.early_stopper.early_stop:
                    print("Early Stopping")
                    return

    # --- persistence --------------------------------------------------------- #
    @property
    def state_path(self) -> str:
        return self.model.filepath + ".train_state"

    def save_state(self) -> None:
        save_train_state(self.state_path, self.params, self.optimizer, self.epoch)

    def load_state(self) -> int:
        """Restore parameters, Adam state and the epoch count; the model
        takes the parameters too. -> the epoch count."""
        self.epoch = load_train_state(self.state_path, self.params, self.optimizer)
        self.model.set_params(self.merge_params(self.model.params(), self.params))
        return self.epoch

    @staticmethod
    def print_epoch_stats(epoch_index, num_epochs, mean_loss_train, mean_accuracy_train,
                          mean_loss_val, mean_accuracy_val, epoch_seconds=None, **_):
        extra = f"\t({epoch_seconds:.1f}s)" if epoch_seconds is not None else ""
        print(f"Train Epoch: {epoch_index + 1}/{num_epochs}{extra}")
        print(f"\tTrain Loss: {mean_loss_train}\tTrain Accuracy: {mean_accuracy_train * 100} %")
        print(f"\tValid Loss: {mean_loss_val}\tValid Accuracy: {mean_accuracy_val * 100} %")
