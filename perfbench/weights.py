"""Random weights from the run's seed, made on the device in one draw.

Every parameter a reference names (``param_specs``: name, shape, kind) is
cut from one standard-normal draw of a ``torch.Generator`` on the device
and scaled by its kind: Xavier-normal for matrices (std sqrt(2 /
(fan_in + fan_out))) times the configuration's ``init_gain``, 1 for
embedding tables (``torch.nn.Embedding``'s own initialisation, which the
published PyTorch models use), 0.01 for biases (not zero, so that
the comparison with the reference covers them), 1 for the learned
constant inputs. They are handed out in the dtype the configuration
serves in; both the program and the reference take these same tensors.
"""
from __future__ import annotations

import math

import torch

BIAS_STD = 0.01


def _std(shape, kind: str, gain: float) -> float:
    if kind == "matrix":
        return gain * math.sqrt(2.0 / (shape[0] + shape[1]))
    if kind == "embedding":
        return 1.0
    if kind == "bias":
        return BIAS_STD
    if kind == "normal":
        return 1.0
    raise ValueError(f"unknown parameter kind {kind!r}")


def make_weights(specs: list, seed: int, device, dtype: torch.dtype,
                 gain: float = 1.0) -> dict:
    """{name: tensor} of ``dtype`` on ``device`` for the (name, shape, kind)
    ``specs``, drawn from ``seed``; matrices at ``gain`` times Xavier's std."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, lo = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        out[name] = (flat[lo:lo + n] * _std(shape, kind, gain)).to(dtype).reshape(shape)
        lo += n
    return out
