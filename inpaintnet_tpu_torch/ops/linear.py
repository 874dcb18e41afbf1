"""Dense / embedding primitives over explicit parameter dicts.

Weights are stored ``(in_dim, out_dim)`` like the JAX package's
(``inpaintnet_tpu/ops/linear.py``), so ``x @ w + b`` applies them and the
two packages' tensors compare like with like. Initialisation draws from a
``numpy.random.Generator`` and returns numpy arrays in that layout; the
model factories convert them (``models/convert.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def xavier_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Xavier/Glorot normal: std = sqrt(2 / (fan_in + fan_out)), float32."""
    fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return (std * rng.standard_normal(shape)).astype(np.float32)


def linear_init(rng: np.random.Generator, in_dim: int, out_dim: int) -> dict:
    return {"w": xavier_normal(rng, (in_dim, out_dim)),
            "b": np.zeros((out_dim,), np.float32)}


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def mlp_selu_init(rng: np.random.Generator, in_dim: int, hidden_dim: int,
                  out_dim: int) -> dict:
    """Two-layer ``Linear -> SELU -> Linear`` head (the encoder's mean and
    log-std heads)."""
    return {"l1": linear_init(rng, in_dim, hidden_dim),
            "l2": linear_init(rng, hidden_dim, out_dim)}


def mlp_selu_apply(params, x: torch.Tensor) -> torch.Tensor:
    return linear_apply(params["l2"], torch.selu(linear_apply(params["l1"], x)))


def embedding_init(rng: np.random.Generator, num_embeddings: int, dim: int) -> dict:
    return {"table": xavier_normal(rng, (num_embeddings, dim))}


def embedding_apply(params, indices: torch.Tensor) -> torch.Tensor:
    """Token lookup: int tensor of any shape -> (..., dim)."""
    return params["table"][indices]
