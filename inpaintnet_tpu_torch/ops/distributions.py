"""Diagonal normal for the VAE latent (``inpaintnet_tpu/ops/distributions.py``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DiagNormal(NamedTuple):
    loc: torch.Tensor
    scale: torch.Tensor

    def rsample(self, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reparameterised sample ``loc + scale * eps``. ``eps`` defaults to
        standard normal noise from ``generator``; a caller may pass its own
        (the parity tests pass the JAX package's noise)."""
        if eps is None:
            eps = torch.randn(self.loc.shape, generator=generator,
                              device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self.scale * eps.to(self.loc.dtype)
