"""Token sampling of the decoders (``inpaintnet_tpu/ops/sampling.py``).

``jax.random.categorical(key, logits)`` is ``argmax(gumbel + logits)``;
``sample_categorical`` takes the Gumbel noise explicitly, so a caller
chooses its stream: a tensor it made (the parity tests pass the JAX
package's own ``jax.random.gumbel`` draws), per-row counter noise
(``row_gumbel``: a row's draws depend on its key alone, the serving
engine's coalescing contract), or a ``torch.Generator`` (``gumbel``).
Threefry is not matched: the streams differ from JAX's, the semantics do
not.
"""
from __future__ import annotations

from typing import Optional

import torch

from inpaintnet_tpu_torch.ops.distributions import draw, row_uniform


def sample_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Top-1 over the last axis; among equal maxima the FIRST index wins
    (``torch.argmax``'s documented rule, the same as ``jnp.argmax`` and the
    decode kernels). ReLU'd logits make all-zero rows common, so the rule
    decides real outputs."""
    return torch.argmax(logits.detach(), dim=-1)


def sample_categorical(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """A categorical draw over the last axis: ``argmax(gumbel + logits)``,
    the noise added in the logits' dtype as ``jax.random.categorical`` adds
    it (a temperature is applied by the caller, to the logits)."""
    return sample_argmax(gumbel.to(logits.dtype) + logits.detach())


def _gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """f32 standard Gumbel noise from ``generator`` (or ``device``'s default):
    ``-log(-log(u))`` of a uniform kept inside (0, 1)."""
    u = draw(torch.rand, shape, generator, device)
    return _gumbel_of_uniform(u.clamp(min=torch.finfo(torch.float32).tiny))


def row_gumbel(row_keys: torch.Tensor, steps: int, vocab: int) -> torch.Tensor:
    """(B, steps, vocab) f32 standard Gumbel noise, element (b, t, v) a pure
    function of ``row_keys[b]`` and ``t * vocab + v`` (``row_uniform``).

    :param row_keys: (B, 2) integer tensor of uint32 values
    """
    u = row_uniform(row_keys, steps * vocab)
    return _gumbel_of_uniform(u).reshape(row_keys.shape[0], steps, vocab)
