"""Explicit random streams (``inpaintnet_tpu/utils/rng.py``).

The JAX package's ``RngStream`` splits a ``jax.random`` key on the host to
give each training step its own key. Here each ``next()`` is a new
``torch.Generator`` seeded from the next child of one
``numpy.random.SeedSequence``: the stream is a pure function of its seed,
the same on every device, and no two of its generators share a seed. (The
TPU's hardware generator, the JAX package's ``impl="rbg"``, has no
counterpart.)
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


class RngStream:
    """Host-side stream of seeded generators.

    :param seed: the stream's seed (a non-negative int)
    :param device: where the generators draw ("cpu" by default: a CPU
        generator gives the same numbers to a run on the card and a run on
        the CPU, ``ops.distributions.draw``)
    """

    def __init__(self, seed: int, device="cpu"):
        self._seq = np.random.SeedSequence(seed)
        self.device = torch.device(device)

    def next(self) -> torch.Generator:
        child = self._seq.spawn(1)[0]
        seed = int(child.generate_state(1, np.uint64)[0]) & (2**63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def next_n(self, n: int) -> List[torch.Generator]:
        return [self.next() for _ in range(n)]
