"""Checkpoints in the JAX package's layout, and the casting of nested
parameters.

``inpaintnet_tpu/models/base.py`` saves a model's parameter pytree as an
``.npz`` whose keys are the ``/``-joined pytree paths (dict keys, and list
indices as digits, e.g. ``encoder/gru/0/1/w_ih``) and whose arrays are the
(in, out) leaves. ``flatten_params`` and ``unflatten_params`` convert the
port's nested parameters to and from that layout, so a checkpoint either
package writes loads in the other; ``load_jax_checkpoint`` reads one into
nested numpy arrays, which ``convert.from_jax_params`` takes.
``CheckpointedModel`` gives a model ``save``, ``save_checkpoint`` and
``load`` at a path named by its ``repr``, as the JAX package's ``Model``.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch


def iter_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of nested dicts and lists, depth first, paths
    ``/``-joined (list indices as digits)."""
    if not isinstance(tree, (dict, list, tuple)):
        yield prefix, tree
        return
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        yield from iter_leaves(v, f"{prefix}/{k}" if prefix else str(k))


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts, lists and tuples, the
    nesting kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_numpy(leaf) -> np.ndarray:
    """A tensor copied to the CPU as numpy (bf16 as f32, which numpy lacks)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def flatten_params(tree) -> Dict[str, np.ndarray]:
    """Nested dicts and lists of tensors (or arrays) -> ``{"a/0/b": array}``."""
    return {k: to_numpy(v) for k, v in iter_leaves(tree)}


def unflatten_params(flat) -> dict:
    """``{"a/0/b": array}`` -> ``{"a": [{"b": array}]}``."""
    root: dict = {}
    for key, value in flat.items():
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return nest_lists(root)


def nest_lists(node):
    """Turn every dict whose keys are exactly 0..n-1 into a list."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not 0..{len(node) - 1}")
        return [nest_lists(node[i]) for i in range(len(node))]
    return {k: nest_lists(v) for k, v in node.items()}


def unflatten_like(template, flat) -> dict:
    """``flat`` (``{"a/0/b": array}``) nested as ``template`` is, every key
    and shape of ``template`` checked (the JAX package's
    ``unflatten_like``): :func:`unflatten_params` of the template's keys,
    as tensors."""
    out = {}
    for key, leaf in iter_leaves(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter {key!r}")
        arr = np.asarray(flat[key])
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key!r}: checkpoint {arr.shape} vs model "
                             f"{tuple(leaf.shape)}")
        out[key] = torch.from_numpy(arr)
    return unflatten_params(out)


def load_jax_checkpoint(path: str) -> dict:
    """Read a JAX package ``.npz`` checkpoint into nested numpy params."""
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})


def cast_params(tree, device, dtype: torch.dtype, copy: bool = False):
    """Nested parameters (dicts and lists of tensors) as contiguous
    ``dtype`` tensors on ``device`` (the JAX package's ``cast_pytree``).
    A leaf already of that device, dtype and layout is returned as it is,
    unless ``copy``: then every leaf is a detached tensor of its own, which
    no later update of ``tree`` reaches (the serving engines' weights)."""
    if isinstance(tree, dict):
        return {k: cast_params(v, device, dtype, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, device, dtype, copy) for v in tree]
    if copy:
        return tree.detach().to(device=device, dtype=dtype, memory_format=torch.contiguous_format,
                                copy=True)
    return tree.to(device=device, dtype=dtype).contiguous()


def cast_pytree(params, dtype: torch.dtype):
    """Every floating leaf of nested parameters cast to ``dtype`` where it
    lies, integer leaves untouched (the JAX package's ``cast_pytree``;
    :func:`cast_params` also moves every leaf to a device)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def npz_path(path: str) -> str:
    """``np.savez`` appends ``.npz`` when absent; so does every load here."""
    return path if path.endswith(".npz") else path + ".npz"


class CheckpointedModel:
    """Config-addressed parameter checkpoints (the JAX package's ``Model``).

    A subclass supplies ``params()`` (nested (in, out) parameters) and
    ``set_params(nested)``; the file is ``<checkpoint_dir>/<repr>.npz`` in
    the layout of :func:`flatten_params`."""

    def __init__(self, checkpoint_dir: Optional[str] = None):
        self.checkpoint_dir = checkpoint_dir or os.path.join(os.getcwd(), "checkpoints")

    @property
    def filepath(self) -> str:
        safe = re.sub(r"[^A-Za-z0-9_.,()\[\]'=-]", "_", repr(self))
        return os.path.join(self.checkpoint_dir, safe + ".npz")

    def save(self, path: Optional[str] = None) -> None:
        path = npz_path(path or self.filepath)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **flatten_params(self.params()))
        print(f"Model {self!r} saved")

    def save_checkpoint(self, epoch_num: int) -> None:
        self.save(f"{self.filepath[:-4]}_{epoch_num}.npz")

    def load(self, path: Optional[str] = None):
        """Read a checkpoint of either package into the model (strict)."""
        path = npz_path(path or self.filepath)
        self.set_params(load_jax_checkpoint(path))
        print(f"Model {self!r} loaded")
        return self


# the JAX package's name of the checkpointed-model base class
Model = CheckpointedModel
