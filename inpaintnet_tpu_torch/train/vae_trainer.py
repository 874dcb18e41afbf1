"""MeasureVAE trainer (``inpaintnet_tpu/train/vae_trainer.py``).

ELBO = token cross-entropy + beta * KLD with a fixed beta of 0.001, the KLD
in f32 whatever the compute dtype, summed over z and averaged over rows.
Every GRU of the training forward runs the trainfast route (K5 and K6 on
the card); evaluation runs the serving routes (K1 and K2 where the
geometry takes them).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from inpaintnet_tpu_torch.ops.distributions import DiagNormal, kl_diag_normal_vs_standard
from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss
from inpaintnet_tpu_torch.train.trainer import Trainer


class VAETrainer(Trainer):
    def __init__(self, dataset, model, lr: float = 1e-4, beta: float = 0.001, **kw):
        self.beta = beta
        super().__init__(dataset, model, lr, **kw)

    def process_batch_data(self, batch) -> torch.Tensor:
        """(B, 1, n_bars * 24) windows -> (B * n_bars, 24) int32 measures on
        the trainer's device."""
        score = np.asarray(batch[0])
        score = score.reshape(score.shape[0] * self.dataset.n_bars, -1).astype(np.int32)
        return torch.from_numpy(score).to(self.device)

    def loss_and_metrics(self, params, batch_data: torch.Tensor, train: bool,
                         eps: Optional[torch.Tensor] = None, coin: Optional[bool] = None,
                         row_mask: Optional[torch.Tensor] = None):
        """:param eps: optional rsample noise; :param coin: optional
        teacher-forcing coin (a test injects the JAX package's); :param
        row_mask: optional (B,) 1 where a row is real (a padded eval tail):
        the means are over real rows, and the metrics carry their ``weight``
        (the real rows)."""
        weights, _, z_dist, _, _, _ = self.model.apply(
            params, batch_data, train=train, generator=self.generator,
            coin_generator=self.coin_generator, eps=eps, coin=coin)
        mask = None if row_mask is None else row_mask[:, None].expand(batch_data.shape)
        recons = mean_crossentropy_loss(weights, batch_data, mask=mask)
        if row_mask is None:
            loss = recons + self.compute_kld_loss(z_dist, beta=self.beta)
        else:
            kld = _kld_rows(z_dist)
            loss = recons + self.beta * (kld * row_mask).sum() / row_mask.sum().clamp_min(1.0)
        metrics = {"accuracy": mean_accuracy(weights, batch_data, mask=mask)}
        if row_mask is not None:
            metrics["weight"] = row_mask.sum()
        return loss, metrics

    @staticmethod
    def compute_kld_loss(z_dist: DiagNormal, prior_dist=None, beta: float = 0.001):
        """beta * the KLD to the standard normal, summed over z and averaged
        over rows, in f32 whatever the compute dtype (``vae_trainer.py:128-139``;
        ``prior_dist`` is unused, as there)."""
        return beta * _kld_rows(z_dist).mean()

    @staticmethod
    def compute_mmd_loss(z_tilde: torch.Tensor, z_prior: torch.Tensor, coeff: float = 10.0):
        """The reference's unused alternative WAE objective, a Gaussian-kernel
        MMD (``vae_trainer.py:81-126``), kept for the API."""
        def kernel(x, y, var=16.0):
            d = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
            return torch.exp(-d / var).sum()

        n = z_tilde.shape[0]
        first = 1.0 / (n * (n - 1)) / 2 if n > 1 else 1.0
        second = 2.0 / (n * n)
        return coeff * (first * kernel(z_prior, z_prior) + first * kernel(z_tilde, z_tilde)
                        - second * kernel(z_prior, z_tilde))


def _kld_rows(z_dist: DiagNormal) -> torch.Tensor:
    """Each row's KLD to the standard normal (summed over z), in f32."""
    return kl_diag_normal_vs_standard(
        DiagNormal(z_dist.loc.float(), z_dist.scale.float())).sum(dim=1)
