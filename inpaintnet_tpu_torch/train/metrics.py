"""Losses and metrics (``inpaintnet_tpu/train/metrics.py``).

They take raw (ReLU'd) logits and integer targets, and an optional
validity mask: only valid positions count, and the divisor is their
number. The softmax and the cross-entropy run in f32 whatever the compute
dtype: in bf16 they would quantize both the loss and its gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from inpaintnet_tpu_torch.ops.sampling import sample_argmax


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        # jnp.mean's rounding: XLA multiplies the sum by the f32 reciprocal
        # of the constant count (a share such as the accuracy then rounds
        # as the JAX package's does)
        return values.sum() * (1.0 / values.numel())
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def mean_crossentropy_loss(weights: torch.Tensor, targets: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy averaged over the (valid) elements.

    :param weights: (..., num_notes) logits; targets: (...) int;
        mask: optional (...), 1 where the element counts
    """
    logp = torch.log_softmax(weights.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return _masked_mean(nll, mask)


def mean_accuracy(weights: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of (valid) elements whose argmax (first index among ties) is
    the target."""
    return _masked_mean((sample_argmax(weights) == targets).float(), mask)


# the reference's 4-D ``*_alt`` variants (trainer.py:345-376): the masked
# forms above take any rank
mean_crossentropy_loss_alt = mean_crossentropy_loss
mean_accuracy_alt = mean_accuracy


def mean_l1_loss(weights: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference, in f32."""
    return (weights.float() - targets.float()).abs().mean()


def mean_mse_loss(weights: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared difference, in f32."""
    return ((weights.float() - targets.float()) ** 2).mean()
