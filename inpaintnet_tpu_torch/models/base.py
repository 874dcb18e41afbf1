"""Checkpoints of the JAX package, read without JAX, and the casting of
nested parameters.

``inpaintnet_tpu/models/base.py`` saves a model's parameter pytree as an
``.npz`` whose keys are the ``/``-joined pytree paths (dict keys, and list
indices as digits, e.g. ``encoder/gru/0/1/w_ih``). ``load_jax_checkpoint``
rebuilds the nested dicts and lists of numpy arrays, which
``convert.from_jax_params`` takes.
"""
from __future__ import annotations

import numpy as np
import torch


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


def load_jax_checkpoint(path: str) -> dict:
    """Read a JAX package ``.npz`` checkpoint into nested numpy params."""
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})


def cast_params(tree, device, dtype: torch.dtype):
    """Nested parameters (dicts and lists of tensors) as contiguous
    ``dtype`` tensors on ``device`` (the JAX package's ``cast_pytree``)."""
    if isinstance(tree, dict):
        return {k: cast_params(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype).contiguous()
