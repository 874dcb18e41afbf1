"""Train-state checkpoints: parameters, Adam moments and a step count in
one flat ``.npz`` (``inpaintnet_tpu/train/checkpoints.py``).

Keys: ``p/<path>`` for each parameter (the JAX package's layout, see
``models/base.flatten_params``), ``o/<path>/{step,exp_avg,exp_avg_sq}``
for its ``torch.optim.Adam`` state (the port's own keys: optax's state
layout is not kept), and ``step``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from inpaintnet_tpu_torch.models.base import npz_path, flatten_params, iter_leaves, to_numpy

ADAM_STATE = ("step", "exp_avg", "exp_avg_sq")


def save_train_state(path: str, params, optimizer: torch.optim.Optimizer, step: int) -> None:
    flat = {f"p/{k}": v for k, v in flatten_params(params).items()}
    for key, p in iter_leaves(params):
        for name, value in optimizer.state.get(p, {}).items():
            if name in ADAM_STATE:
                flat[f"o/{key}/{name}"] = to_numpy(value)
    flat["step"] = np.asarray(step)
    path = npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_train_state(path: str, params, optimizer: torch.optim.Optimizer) -> int:
    """Restore the parameters (in place) and the Adam state of ``params``'
    leaves from ``path``; -> the saved step."""
    with np.load(npz_path(path)) as z:
        flat = {k: z[k] for k in z.files}
    for key, p in iter_leaves(params):
        saved = flat.get(f"p/{key}")
        if saved is None:
            raise KeyError(f"train state lacks parameter {key!r}")
        if saved.shape != tuple(p.shape):
            raise ValueError(f"{key!r}: saved {saved.shape}, model {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(saved))
        state = {name: torch.from_numpy(flat[f"o/{key}/{name}"]) for name in ADAM_STATE
                 if f"o/{key}/{name}" in flat}
        if state:
            for name in ("exp_avg", "exp_avg_sq"):
                state[name] = state[name].to(device=p.device, dtype=p.dtype)
            optimizer.state[p] = state
    return int(flat["step"])
