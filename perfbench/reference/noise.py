"""The per-row noise of a served LatentRNN request, worked out again from
the request's seed: a frozen copy of plain integer arithmetic (splitmix64),
so that the reference reads nothing the program made.

- ``row_keys(seed, n)``: the (n, 2) uint32 keys of the n rows of a request
  with seed ``seed``: a double splitmix64 hash of (seed, row).
- ``row_normal(keys, count)``: (B, count) f32 standard normals, element i
  of row b from the 64 bits ``splitmix64(splitmix64(key_b) ^ i)``: Box-Muller
  on two 23-bit uniforms cut from those bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix_np(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return x ^ (x >> np.uint64(31))


def row_keys(seed: int, n: int) -> np.ndarray:
    """(n, 2) uint32 keys of rows 0..n-1 of a request seeded ``seed``."""
    with np.errstate(over="ignore"):
        s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
        base = _mix_np(np.full(n, s, np.uint64))
        j = np.arange(n, dtype=np.uint64)
        h = _mix_np(base ^ ((j * np.uint64(0xD2B74407B1CE6E93) + np.uint64(1)) & _M64))
    return np.stack([(h >> np.uint64(32)).astype(np.uint32),
                     (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the 64 bits an int64 tensor holds."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix_t(x: torch.Tensor) -> torch.Tensor:
    x = x + _signed(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _signed(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def row_normal(keys: np.ndarray, count: int, device) -> torch.Tensor:
    """(B, count) f32 standard normals of the rows whose keys are ``keys``."""
    k = torch.from_numpy(keys.astype(np.int64)).to(device)
    key64 = (k[:, 0] << 32) | k[:, 1]
    idx = torch.arange(count, device=device, dtype=torch.int64)
    bits = _mix_t(_mix_t(key64)[:, None] ^ idx[None, :])
    u1 = (_shr(bits, 41).float() + 0.5) * 2.0 ** -23
    u2 = ((bits >> 9) & ((1 << 23) - 1)).float() * 2.0 ** -23
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
