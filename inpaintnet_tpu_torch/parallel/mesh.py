"""Device meshes for data parallelism (``inpaintnet_tpu/parallel/mesh.py``).

A mesh has the axes ("data", "model") and is one of two things:

- **local**: a list of devices of this process, one a data index (the
  serving engine's): ``shard_batch`` splits a batch's rows over them, and
  each shard runs on its own device. A mesh may name one device more than
  once (the JAX package's tests do the same with eight virtual CPU
  devices; a card machine may have one card): shards on one device run
  in turn.
- **world**: the processes of the initialised ``torch.distributed`` group,
  one a data index, rank r on its own device (the trainers', under
  ``torchrun``): a process holds rank r's shard only.

Arrays are not global: a "sharded" batch is the list of the shards this
process holds, in data-index order, each on its device. The "model" axis
is reserved: tensor parallelism (the JAX package's ``shard_params``) is not
ported, and a mesh with ``model > 1`` raises.

The semantics and messages follow the JAX package: an indivisible batch is
replicated on every shard with a warning once a process (``shard_batch``),
multi-process batches never fall back to replication
(``make_global_batch``), and eval tails are padded and row-masked
(``pad_rows_to_divisible``).
"""
from __future__ import annotations

import math
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from inpaintnet_tpu_torch.models.base import iter_leaves, tree_map

TENSOR_PARALLEL = ("a mesh 'model' axis above 1 (tensor parallelism, the JAX package's "
                   "shard_params) is not ported: ROADMAP.md §1, 'Modules to port'")


def fold_seed(seed: int, index: int) -> int:
    """A 63-bit seed hashed from (``seed``, ``index``): a shard's noise seed
    from its batch's (the JAX package's ``fold_in(key, axis_index)``)."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return int(state) & (2**63 - 1)


def free_port() -> int:
    """A free TCP port on ``localhost``: the rendezvous address of a process
    group started on one host (``tcp://localhost:<port>``)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def process_count() -> int:
    """Processes of the initialised ``torch.distributed`` group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A ("data", "model") mesh: ``devices`` a data index (local), or this
    rank's device alone (world: ``distributed``, data index = rank)."""

    def __init__(self, devices: Sequence, data: int, model: int = 1,
                 distributed: bool = False):
        if model != 1:
            raise NotImplementedError(TENSOR_PARALLEL)
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"data": data, "model": model}
        self.distributed = distributed

    def local_indices(self) -> List[int]:
        """The data indices whose shards this process holds."""
        return [process_index()] if self.distributed else list(range(self.shape["data"]))

    def __repr__(self):
        kind = "world" if self.distributed else "local"
        return f"Mesh({kind}, data={self.shape['data']}, devices={self.devices})"


def default_device() -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (or ``cuda``) where there is
    a card, else the CPU."""
    import os

    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def make_mesh(num_devices: Optional[int] = None, data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh. With ``devices``, a local mesh over them;
    without, the world of the process group where one is initialised (this
    rank on :func:`default_device`), else a local mesh over every card of
    the host (the CPU without one). ``num_devices`` keeps the first ones."""
    if devices is None and process_count() > 1:
        n = process_count() if num_devices is None else num_devices
        data = n // model if data is None else data
        if n != process_count() or data * model != n:
            raise ValueError(f"{data}x{model} mesh != {process_count()} processes")
        return Mesh([default_device()], data, model, distributed=True)
    if devices is None:
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(count)] if count
                   else [torch.device("cpu")])
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} mesh != {n} devices")
    return Mesh(devices, data, model)


def _tree_leaves(tree) -> list:
    return [leaf for _, leaf in iter_leaves(tree)]


def _rows(batch) -> int:
    return _tree_leaves(batch)[0].shape[0]


def _to(x, device: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def take_rows(tree, lo: int, hi: int, rows: int):
    """Rows [lo, hi) of every tensor or array of ``tree`` whose leading
    dimension is ``rows`` (a batch's); other leaves (a coin, a scalar) as
    they are."""
    def take(x):
        if hasattr(x, "shape") and len(x.shape) > 0 and x.shape[0] == rows:
            return x[lo:hi]
        return x
    return tree_map(take, tree)


_warned = False


def _warn_replicated(rows: int, data_axis: int) -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            f"batch leading dim {rows} does not divide the {data_axis}-way data axis; "
            "replicating this batch on every device (correct but redundant — expected only "
            "for tail batches)", stacklevel=3)


def shard_batch(mesh: Mesh, batch) -> list:
    """The shards of a batch (nested dicts, lists and tuples of tensors or
    arrays, every leaf with the batch's rows leading) that this process
    holds: data index i takes rows [i n / D, (i + 1) n / D), on its device.
    A batch that the data axis does not divide is replicated instead (every
    shard the whole batch), with a warning once a process."""
    data_axis = mesh.shape["data"]
    rows = _rows(batch)
    divisible = all(x.shape[0] % data_axis == 0 for x in _tree_leaves(batch))
    if not divisible:
        _warn_replicated(rows, data_axis)
    per = rows // data_axis
    shards = []
    for k, i in enumerate(mesh.local_indices()):
        lo, hi = (i * per, (i + 1) * per) if divisible else (0, rows)
        device = mesh.devices[0 if mesh.distributed else k]
        shards.append(tree_map(lambda x, d=device: _to(x, d), take_rows(batch, lo, hi, rows)))
    return shards


def replicate(mesh: Mesh, tree) -> list:
    """A copy of ``tree`` on each device of this process's shards (one
    object a device: shards on one device share it)."""
    copies = {}
    out = []
    for k, _ in enumerate(mesh.local_indices()):
        device = mesh.devices[0 if mesh.distributed else k]
        if device not in copies:
            copies[device] = tree_map(lambda x: _to(x, device), tree)
        out.append(copies[device])
    return out


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    """Rows THIS process must supply for a ``global_batch``-row step."""
    if global_batch % process_count() != 0:
        raise ValueError(f"global batch {global_batch} must divide the "
                         f"{process_count()} processes")
    return global_batch // process_count()


def make_global_batch(mesh: Mesh, local_batch) -> list:
    """Multi-process input feeding: this process's rows (``local_batch_size``
    of the global batch) as its shards. A world mesh's process holds one
    shard, its rows; a local mesh splits them as :func:`shard_batch`. A
    global row count that the data axis does not divide raises: no process
    holds the global rows, so there is no replication to fall back to.
    Single-process this is exactly ``shard_batch`` on a divisible batch."""
    nproc = process_count()
    data_axis = mesh.shape["data"]
    for x in _tree_leaves(local_batch):
        global_rows = x.shape[0] * nproc
        if global_rows % data_axis:
            raise ValueError(
                f"global batch {global_rows} ({x.shape[0]} local rows x {nproc} processes) "
                f"does not divide the {data_axis}-way data axis; multi-host batches cannot "
                "fall back to replication (no process holds the global rows) — drop or pad "
                "the tail instead")
    if mesh.distributed:
        return [tree_map(lambda x: _to(x, mesh.devices[0]), local_batch)]
    return shard_batch(mesh, local_batch)


def pad_rows_to_divisible(batch, data_axis: int, process_count: int):
    """Pad a process-local batch's leading dim so the GLOBAL row count
    divides the data axis, and return the per-row validity mask.

    :param batch: nested numpy arrays (or tensors), equal leading dim = local rows
    :return: (padded batch, row_mask (padded_rows,) float32, 1 = real) —
        the input batch and ``None`` if already divisible
    """
    rows = _rows(batch)
    if (rows * process_count) % data_axis == 0:
        return batch, None
    # r' * P % D == 0  <=>  r' % (D / gcd(D, P)) == 0
    step = data_axis // math.gcd(data_axis, process_count)
    padded_rows = (rows + step - 1) // step * step
    row_mask = np.zeros(padded_rows, dtype=np.float32)
    row_mask[:rows] = 1.0
    return pad_leading(batch, rows, padded_rows), row_mask


def pad_leading(tree, rows: int, padded_rows: int):
    """Every numpy array or tensor of ``tree`` whose leading dimension is
    ``rows``, zero-padded to ``padded_rows``; other leaves as they are."""
    def pad(x):
        if not hasattr(x, "shape") or len(x.shape) == 0 or x.shape[0] != rows:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((padded_rows - rows,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((padded_rows - rows,) + x.shape[1:], dtype=x.dtype)])
    return tree_map(pad, tree)


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Average ``tensors`` in place over the process group (one collective
    over a flat buffer; gloo reduces on the host, so a CUDA buffer goes
    through the CPU there). No-op without a group."""
    if not tensors or not (dist.is_available() and dist.is_initialized()):
        return
    n = process_count()
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if dist.get_backend() == "gloo" and flat.is_cuda:
        host = flat.cpu()
        dist.all_reduce(host)
        flat = host.to(flat.device)
    else:
        dist.all_reduce(flat)
    flat /= n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
