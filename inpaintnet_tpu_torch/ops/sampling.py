"""Token sampling of the decoders (``inpaintnet_tpu/ops/sampling.py``)."""
from __future__ import annotations

import torch


def sample_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Top-1 over the last axis; among equal maxima the FIRST index wins
    (``torch.argmax``'s documented rule, the same as ``jnp.argmax`` and the
    decode kernels). ReLU'd logits make all-zero rows common, so the rule
    decides real outputs."""
    return torch.argmax(logits.detach(), dim=-1)
