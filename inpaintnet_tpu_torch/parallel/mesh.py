"""Device meshes (``inpaintnet_tpu/parallel/mesh.py``).

A mesh has the axes ("data", "model") and is one of two things:

- **local**: devices of this process forming a (data, model) grid in
  row-major order (the JAX package's ``np.asarray(devices).reshape(data,
  model)``): ``shard_batch`` splits a batch's rows over the data axis, and
  data index d runs on the grid's device (d, 0). A mesh may name one device
  more than once (the JAX package's tests do the same with eight virtual
  CPU devices; a card machine may have one card): shards on one device run
  in turn.
- **world**: the processes of the initialised ``torch.distributed`` group,
  rank r at data index ``r // model`` and model index ``r % model``, each on
  its own device (the trainers', under ``torchrun``): a process holds its
  data index's shard only, and model peers (the ranks of one data index)
  hold the same rows. With ``model > 1`` every rank builds one process group
  per data index (its model peers) and one per model index (its data peers).

Arrays are not global: a "sharded" batch is the list of the shards this
process holds, in data-index order, each on its device; a replicated tree is
a copy a shard. Tensor parallelism (:func:`shard_params`) splits the output
dimension of every gate matrix into ``model`` column blocks, a block a model
index (:class:`ShardedLeaf`); :func:`gather_params` gathers the whole
matrices where a forward reads them, with a backward that narrows the
gradient to the block.

The semantics and messages follow the JAX package: an indivisible batch is
replicated on every shard with a warning once a process (``shard_batch``),
multi-process batches never fall back to replication
(``make_global_batch``), and eval tails are padded and row-masked
(``pad_rows_to_divisible``).
"""
from __future__ import annotations

import math
import warnings
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from inpaintnet_tpu_torch.models.base import iter_leaves, tree_map


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
    """A ("data", "model") mesh: ``devices`` the (data, model) grid in
    row-major order (local), or this rank's device alone (world:
    ``distributed``). A world mesh with ``model > 1`` makes its process
    groups here, so every rank must build it, in the same order."""

    def __init__(self, devices: Sequence, data: int, model: int = 1,
                 distributed: bool = False):
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"data": data, "model": model}
        self.distributed = distributed
        # the collectives' groups: data peers (gradient means) and model
        # peers (gathers); None is the whole world
        self.data_group = self.model_group = None
        if distributed and model > 1:
            rank = process_index()
            for d in range(data):
                group = dist.new_group([d * model + m for m in range(model)])
                if rank // model == d:
                    self.model_group = group
            for m in range(model):
                group = dist.new_group([d * model + m for d in range(data)])
                if rank % model == m:
                    self.data_group = group

    def local_indices(self) -> List[int]:
        """The data indices whose shards this process holds."""
        if self.distributed:
            return [process_index() // self.shape["model"]]
        return list(range(self.shape["data"]))

    def model_indices(self) -> List[int]:
        """The model indices whose blocks this process holds."""
        if self.distributed:
            return [process_index() % self.shape["model"]]
        return list(range(self.shape["model"]))

    def device_of(self, data_index: int, model_index: int = 0) -> torch.device:
        """The device of grid position (``data_index``, ``model_index``)
        (a world mesh: this rank's)."""
        if self.distributed:
            return self.devices[0]
        return self.devices[data_index * self.shape["model"] + model_index]

    def __repr__(self):
        kind = "world" if self.distributed else "local"
        return (f"Mesh({kind}, data={self.shape['data']}, model={self.shape['model']}, "
                f"devices={self.devices})")


class Placement(NamedTuple):
    """Where a tree goes on a mesh (the JAX package's ``NamedSharding``):
    ``spec`` ``("data",)`` splits leading rows over the data axis, ``()``
    copies the tree whole to every shard. The port's arrays are not global,
    so a placement names the devices of this process's shards."""

    mesh: Mesh
    spec: tuple

    def devices(self) -> List[torch.device]:
        """The device of each of this process's data shards."""
        return [self.mesh.device_of(i) for i in self.mesh.local_indices()]


def batch_sharding(mesh: Mesh) -> Placement:
    """Leading-axis (batch) placement over the data axis."""
    return Placement(mesh, ("data",))


def replicated(mesh: Mesh) -> Placement:
    """A whole copy on every shard."""
    return Placement(mesh, ())


def default_device() -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (or ``cuda``) where there is
    a card, else the CPU."""
    import os

    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def make_mesh(num_devices: Optional[int] = None, data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh. With ``devices``, a local mesh over them
    (the (data, model) grid in row-major order); without, the world of the
    process group where one is initialised (this rank on
    :func:`default_device`), else a local mesh over every card of the host
    (the CPU without one). ``num_devices`` keeps the first ones."""
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
    holds (:func:`batch_sharding`): data index i takes rows
    [i n / D, (i + 1) n / D), on its device. A batch that the data axis does
    not divide is replicated instead (:func:`replicated`: every shard the
    whole batch), with a warning once a process."""
    data_axis = mesh.shape["data"]
    rows = _rows(batch)
    divisible = all(x.shape[0] % data_axis == 0 for x in _tree_leaves(batch))
    if not divisible:
        _warn_replicated(rows, data_axis)
        return replicate(mesh, batch)
    per = rows // data_axis
    return [tree_map(lambda x, d=device: _to(x, d), take_rows(batch, i * per, (i + 1) * per, rows))
            for i, device in zip(mesh.local_indices(), batch_sharding(mesh).devices())]


def replicate(mesh: Mesh, tree) -> list:
    """A copy of ``tree`` on each device of this process's shards
    (:func:`replicated`; one object a device: shards on one device share
    it)."""
    copies = {}
    out = []
    for device in replicated(mesh).devices():
        if device not in copies:
            copies[device] = tree_map(lambda x: _to(x, device), tree)
        out.append(copies[device])
    return out


def _feeders(mesh: Mesh) -> int:
    """The processes that feed distinct rows: model peers feed the same."""
    return process_count() // mesh.shape["model"] if mesh.distributed else process_count()


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    """Rows THIS process must supply for a ``global_batch``-row step (model
    peers supply the same rows)."""
    feeders = _feeders(mesh)
    if global_batch % feeders != 0:
        raise ValueError(f"global batch {global_batch} must divide the "
                         f"{feeders} processes")
    return global_batch // feeders


def make_global_batch(mesh: Mesh, local_batch) -> list:
    """Multi-process input feeding: this process's rows (``local_batch_size``
    of the global batch) as its shards. A world mesh's process holds one
    shard, its rows (its model peers the same); a local mesh splits them as :func:`shard_batch`. A
    global row count that the data axis does not divide raises: no process
    holds the global rows, so there is no replication to fall back to.
    Single-process this is exactly ``shard_batch`` on a divisible batch."""
    nproc = _feeders(mesh)
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


def all_reduce_mean(tensors: List[torch.Tensor], group=None) -> None:
    """Average ``tensors`` in place over ``group`` (the whole process group
    by default; one collective over a flat buffer; gloo reduces on the host,
    so a CUDA buffer goes through the CPU there). No-op without a group."""
    if not tensors or not (dist.is_available() and dist.is_initialized()):
        return
    n = dist.get_world_size(group)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if dist.get_backend(group) == "gloo" and flat.is_cuda:
        host = flat.cpu()
        dist.all_reduce(host, group=group)
        flat = host.to(flat.device)
    else:
        dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


# --- tensor parallelism: the "model" axis ------------------------------------ #
def is_gate_matrix(path: str, x) -> bool:
    """The leaves :func:`shard_params` splits (the JAX package's
    ``_is_gate_matrix``): 2-D, a GRU's ``w_ih`` / ``w_hh`` or a linear
    layer's ``w`` (the last key), whose output (last) dimension is a
    multiple of 128."""
    shape = getattr(x, "shape", ())
    return (len(shape) == 2 and ("w_ih" in path or "w_hh" in path
                                 or path.split("/")[-1] == "w")
            and shape[-1] % 128 == 0)


class ShardedLeaf:
    """A gate matrix split along its last dimension into ``count`` equal
    column blocks, block m at model index m. ``blocks`` are the blocks this
    process holds, from model index ``index`` on (a world rank: its own
    one; a local mesh: all of them, block m on the grid's device (d, m));
    ``group`` is the world's model group (None on a local mesh).
    :meth:`gather` gives the whole matrix."""

    def __init__(self, blocks: List[torch.Tensor], index: int, count: int, group=None):
        self.blocks = blocks
        self.index = index
        self.count = count
        self.group = group

    @property
    def block(self) -> torch.Tensor:
        return self.blocks[0]

    @property
    def shape(self) -> tuple:
        return (*self.block.shape[:-1], self.block.shape[-1] * self.count)

    @property
    def nbytes(self) -> int:
        """Bytes of the blocks this process holds."""
        return sum(b.numel() * b.element_size() for b in self.blocks)

    def gather(self) -> torch.Tensor:
        """The whole matrix on the first block's device; differentiable: the
        gradient of the whole reaches each block as its columns."""
        if self.group is None:
            device = self.block.device
            return torch.cat([b.to(device) for b in self.blocks], dim=-1)
        return _GatherBlocks.apply(self.block, self)

    def __repr__(self):
        return (f"ShardedLeaf(shape={self.shape}, block={tuple(self.block.shape)}, "
                f"index={self.index}, count={self.count})")


def all_gather_columns(block: torch.Tensor, count: int, group) -> torch.Tensor:
    """The ``count`` model peers' blocks side by side along the last
    dimension (an ``all_gather`` over ``group``). The blocks travel as
    bytes, whatever their dtype; gloo gathers on the host, so a CUDA block
    goes through the CPU there."""
    wire = block.contiguous().view(torch.uint8)
    via_host = wire.is_cuda and dist.get_backend(group) == "gloo"
    if via_host:
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(count)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=-1).to(block.device).view(block.dtype)


class _GatherBlocks(torch.autograd.Function):
    """Forward: the whole matrix from the model peers' blocks. Backward: the
    incoming gradient's columns of this rank's block. Exact: every model
    peer computes the same forward on the same rows with the same noise, so
    each holds the same gradient of the whole matrix."""

    @staticmethod
    def forward(ctx, block, leaf):
        ctx.lo, ctx.width = leaf.index * block.shape[-1], block.shape[-1]
        return all_gather_columns(block, leaf.count, leaf.group)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.lo:ctx.lo + ctx.width].contiguous(), None


def shard_params(mesh: Mesh, params) -> list:
    """Tensor-parallel placement (the JAX package's ``shard_params``): every
    gate matrix (:func:`is_gate_matrix`) as a :class:`ShardedLeaf` of
    ``model`` column blocks, every other leaf replicated. -> a tree a data
    shard of this process, as :func:`replicate` (one object a device).
    With ``model == 1`` this is ``replicate``. A block requires a gradient
    where its matrix does, and is a leaf tensor an optimiser can own."""
    model = mesh.shape["model"]
    if model == 1:
        return replicate(mesh, params)
    out, trees = [], {}
    for d in mesh.local_indices():
        device = mesh.device_of(d)
        if device not in trees:
            trees[device] = _shard_tree(mesh, params, d)
        out.append(trees[device])
    return out


def _shard_tree(mesh: Mesh, params, data_index: int):
    model = mesh.shape["model"]
    indices = mesh.model_indices()

    def place(path, x):
        if not is_gate_matrix(path, x):
            return _to(x, mesh.device_of(data_index))
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        width = x.shape[-1] // model
        blocks = [x.detach()[..., m * width:(m + 1) * width]
                  .to(mesh.device_of(data_index, m), copy=True).contiguous()
                  .requires_grad_(x.requires_grad) for m in indices]
        return ShardedLeaf(blocks, indices[0], model, mesh.model_group)

    return _map_with_paths(place, params)


def _map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over nested dicts, lists and tuples, paths as
    :func:`iter_leaves` names them."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                          for k, v in enumerate(tree))
    return fn(prefix, tree)


def gather_params(tree):
    """``tree`` with every :class:`ShardedLeaf` gathered whole (a collective
    over the model group on a world mesh: every model peer calls it on the
    same tree); other leaves as they are."""
    return tree_map(lambda x: x.gather() if isinstance(x, ShardedLeaf) else x, tree)


def trainable_leaves(tree) -> List[torch.Tensor]:
    """The tensors an optimiser owns in a :func:`shard_params` tree: each
    sharded leaf's blocks, and every other leaf."""
    out = []
    for _, x in iter_leaves(tree):
        out.extend(x.blocks if isinstance(x, ShardedLeaf) else [x])
    return out


def gate_bytes(tree) -> tuple:
    """(bytes this process holds of the gate matrices, their whole bytes)."""
    held = whole = 0
    for _, x in iter_leaves(tree):
        if isinstance(x, ShardedLeaf):
            held += x.nbytes
            whole += math.prod(x.shape) * x.block.element_size()
    return held, whole
