"""Diagonal normal for the VAE latent (``inpaintnet_tpu/ops/distributions.py``),
its KL to the standard normal, inverted dropout, and the per-row noise and
key splits of the serving engine's coalesced batches."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


def draw(fn, shape, generator: Optional[torch.Generator], device,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``fn(shape)`` (``torch.rand`` or ``torch.randn``) in ``dtype``, drawn
    on the generator's device and moved to ``device``: the same seeded CPU
    generator then gives the same noise to a run on the card and a run on
    the CPU. Without a generator, draws on ``device`` from its default."""
    if generator is None:
        return fn(shape, device=device, dtype=dtype)
    return fn(shape, generator=generator, device=generator.device, dtype=dtype).to(device)


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` in ``x``'s dtype, the division a
    true f32 one rounded once, as JAX divides. The divisor is a tensor on
    ``x``'s device: PyTorch's CUDA division by a Python number multiplies by
    its reciprocal, which differs by an ulp where that is inexact (rate 0.3).
    Every dropout of the port goes through here, K1's plain training mode
    too, so its kernel and the eager route drop bit-identically."""
    div = torch.full((), 1.0 - rate, dtype=torch.float32, device=x.device)
    return torch.where(keep, x.float() / div, torch.zeros((), device=x.device)).to(x.dtype)


def seeded_normal(seed: int, index: int, shape, device) -> torch.Tensor:
    """Standard normal noise of ``shape`` from a CPU generator seeded by
    (``seed``, ``index``), moved to ``device``: the testers' rsample noise
    of batch ``index``, the same on the card and on the CPU (a CUDA and a
    CPU generator give different streams)."""
    mixed = int(np.random.SeedSequence([seed, index]).generate_state(1)[0])
    generator = torch.Generator().manual_seed(mixed)
    return torch.randn(tuple(shape), generator=generator).to(device)


class DiagNormal(NamedTuple):
    loc: torch.Tensor
    scale: torch.Tensor

    def rsample(self, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reparameterised sample ``loc + scale * eps`` (pathwise gradients
        reach loc and scale). ``eps`` defaults to standard normal noise
        from ``generator``; a caller may pass its own (the parity tests
        pass the JAX package's noise)."""
        if eps is None:
            eps = draw(torch.randn, self.loc.shape, generator, self.loc.device, self.loc.dtype)
        return self.loc + self.scale * eps.to(self.loc.dtype)

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`rsample` without gradients."""
        return self.rsample(generator, eps).detach()

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise log density at ``x``."""
        var = self.scale ** 2
        return -0.5 * (torch.log(2 * math.pi * var) + (x - self.loc) ** 2 / var)


def kl_diag_normal_vs_standard(dist: DiagNormal) -> torch.Tensor:
    """KL(N(loc, scale^2) || N(0, 1)), elementwise, in the tensors' dtype."""
    var = dist.scale ** 2
    return 0.5 * (var + dist.loc ** 2 - 1.0) - torch.log(dist.scale)


def _u64(c: int) -> int:
    """A 64-bit constant as the int64 holding the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the 64 bits an int64 tensor holds."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 tensors read as uint64 bits: int64
    addition and multiplication wrap modulo 2^64 on every device, so the
    bits equal the uint64 hash (``serve._splitmix64`` in numpy)."""
    x = x + _u64(0x9E3779B97F4A7C15)
    x = (x ^ _srl(x, 30)) * _u64(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _u64(0x94D049BB133111EB)
    return x ^ _srl(x, 31)


def row_bits(row_keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) int64 random bits: element i of row b is
    ``splitmix64(splitmix64(key_b) ^ i)`` with ``key_b = k0 << 32 | k1``, a
    pure function of ``row_keys[b]`` and ``i``.

    :param row_keys: (B, 2) integer tensor of uint32 values
    """
    keys = row_keys.long()
    key64 = (keys[:, 0] << 32) | keys[:, 1]
    idx = torch.arange(n, device=row_keys.device, dtype=torch.int64)
    return splitmix64(splitmix64(key64)[:, None] ^ idx[None, :])


_SPLIT_TAG = _u64(0x5851F42D4C957F2D)  # sets the keys of row_split apart from row_bits' bits


def row_split(row_keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n, 2) child keys of uint32 values (in int64): child i of row b is
    the 64-bit ``splitmix64(splitmix64(key_b ^ TAG) ^ i)``, split into its
    high and low halves, a pure function of ``row_keys[b]`` and ``i``. The
    port's counterpart of ``jax.vmap(jax.random.split)`` on per-row keys: it
    gives a row independent streams (the autoregressive LatentRNN's context
    and re-encode draws) that still depend on that row's key alone. ``TAG``
    keeps the children apart from the noise bits :func:`row_bits` draws
    from the same key.

    :param row_keys: (B, 2) integer tensor of uint32 values
    """
    keys = row_keys.long()
    key64 = (keys[:, 0] << 32) | keys[:, 1]
    idx = torch.arange(n, device=row_keys.device, dtype=torch.int64)
    h = splitmix64(splitmix64(key64 ^ _SPLIT_TAG)[:, None] ^ idx[None, :])
    return torch.stack([_srl(h, 32), h & 0xFFFFFFFF], dim=-1)


def _top23_uniform(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniforms strictly inside (0, 1): the top 23 of each element's 64
    hash bits, offset by half a step (so a log of them stays finite)."""
    return (_srl(bits, 41).float() + 0.5) * 2.0 ** -23


def row_uniform(row_keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1), element i of row b a pure function of
    ``row_keys[b]`` and ``i`` (:func:`row_bits`)."""
    return _top23_uniform(row_bits(row_keys, n))


def row_normal(row_keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(B, *shape) f32 standard normal noise in one vectorised pass, row ``b``
    drawn from ``row_keys[b]`` alone: Box-Muller on two 23-bit uniforms cut
    from each element's 64 hash bits (:func:`row_bits`), in f32. This is
    the port's counterpart of ``jax.random.normal`` under per-row threefry
    keys; the streams differ, the contract (a row's noise depends on its
    key and nothing else) is the same."""
    n = math.prod(shape)
    bits = row_bits(row_keys, n)
    u1 = _top23_uniform(bits)
    u2 = ((bits >> 9) & ((1 << 23) - 1)).float() * 2.0 ** -23
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(row_keys.shape[0], *shape)
