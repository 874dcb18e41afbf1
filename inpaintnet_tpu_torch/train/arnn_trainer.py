"""AnticipationRNN trainers (``inpaintnet_tpu/train/arnn_trainer.py``).

- ``AnticipationRNNGaussianRegTrainer``: a contiguous target span (2 to 6
  measures) is unconstrained, the ticks before and after it constrained;
  one span a batch, drawn on the host from
  ``numpy.random.RandomState(seed + 29)`` as the JAX package draws it, so
  the masks of a run are bit-equal to its.
- ``AnticipationRNNBaselineTrainer``: a scattered Bernoulli(p ~ U[0, 0.5])
  constraint mask a batch, which all its rows share, from the same stream.

The loss is the cross-entropy and accuracy of the unconstrained ticks, in
f32. ``gaussian_reg_coeff`` (default 0.0, as the reference ships it: it
defines the term but never adds it) adds a regularizer of the LSTMs'
activations to train steps; such a step always runs the teacher-forced pass,
which returns them. On the card a train step runs the eager LSTM loops
under autograd; the validation pass runs the argmax decode on K7.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from inpaintnet_tpu_torch.models.measure_vae import NUM_TICKS_PER_MEASURE
from inpaintnet_tpu_torch.train.latent_rnn_trainer import split_to_measures
from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss
from inpaintnet_tpu_torch.train.trainer import Trainer


class AnticipationRNNGaussianRegTrainer(Trainer):
    min_num_measures_target = 2
    max_num_measure_target = 6

    def __init__(self, dataset, model, lr: float = 1e-4, early_stopping: bool = False,
                 gaussian_reg_coeff: float = 0.0, seed: int = 0,
                 compute_dtype: Optional[str] = None, device="cuda", **kw):
        # the span draws num_past from [1, n_bars - num_target - 1), a
        # range that is empty for the largest target below this
        if dataset.n_bars < self.max_num_measure_target + 3:
            raise ValueError(f"n_bars {dataset.n_bars} too small for max target "
                             f"{self.max_num_measure_target} (need >= target + 3)")
        super().__init__(dataset, model, lr, early_stopping, seed=seed,
                         compute_dtype=compute_dtype, device=device, **kw)
        self.gaussian_reg_coeff = gaussian_reg_coeff
        if hasattr(dataset, "subdivision") and hasattr(dataset, "num_beats_per_bar"):
            self.measure_seq_len = dataset.subdivision * dataset.num_beats_per_bar
        else:
            self.measure_seq_len = NUM_TICKS_PER_MEASURE
        self._np_rng = np.random.RandomState(seed + 29)

    # --- batch prep ---------------------------------------------------------- #
    def _to_device(self, score: np.ndarray, metadata: np.ndarray, loc: np.ndarray):
        """(B, 1, T) windows, their (B, 1, T, num_md) metadata and a
        constraint mask -> (score (B, T), metadata (B, T, num_md), loc
        (B, T)), int32 tensors on the trainer's device."""
        b = score.shape[0]
        arrays = (score.reshape(b, -1), metadata.reshape(b, score.shape[-1], -1),
                  loc.reshape(b, -1))
        return tuple(torch.from_numpy(a.astype(np.int32)).to(self.device) for a in arrays)

    def process_batch_data(self, batch):
        score_tensor = np.asarray(batch[0])
        loc, _, _ = self.get_constraints_location(score_tensor)
        return self._to_device(score_tensor, np.asarray(batch[1]), loc)

    def get_num_target_stochastic(self) -> int:
        """A span's measure count, drawn from the trainer's numpy stream."""
        return int(self._np_rng.randint(self.min_num_measures_target,
                                        self.max_num_measure_target + 1))

    def get_num_past_stochastic(self, num_target: int, num_measures: int) -> int:
        """The past measures before a ``num_target``-measure span."""
        return int(self._np_rng.randint(1, num_measures - num_target - 1))

    def get_constraints_location(self, score_tensor: np.ndarray, extra_outs: bool = False,
                                 fix_num_target: Optional[int] = None):
        """A contiguous span (reference :93-128: the span starts at measure
        ``num_past + 1``, and the ticks after it stay unconstrained when it
        ends at the last tick). -> (constraints_location like
        ``score_tensor``, start_tick, end_tick[, num_past, num_target])."""
        num_measures = split_to_measures(score_tensor, self.measure_seq_len).shape[1]
        if num_measures != self.dataset.n_bars:
            raise ValueError(f"{num_measures} measures a window, dataset has "
                             f"{self.dataset.n_bars} bars")
        num_target = (fix_num_target if fix_num_target is not None
                      else self.get_num_target_stochastic())
        num_past = self.get_num_past_stochastic(num_target, num_measures)
        start_tick = (num_past + 1) * self.measure_seq_len
        end_tick = start_tick + num_target * self.measure_seq_len
        loc = np.zeros_like(score_tensor)
        if start_tick > 0:
            loc[:, :, :start_tick] = 1
        if end_tick < loc.shape[2] - 1:
            loc[:, :, end_tick:] = 1
        if extra_outs:
            return loc, start_tick, end_tick, num_past, num_target
        return loc, start_tick, end_tick

    # --- loss ---------------------------------------------------------------- #
    def loss_and_metrics(self, params, batch_data, train: bool, coin: Optional[bool] = None,
                         masks: Optional[dict] = None, row_mask: Optional[torch.Tensor] = None):
        """:param coin, masks: optional teacher-forcing coin and dropout keep
        masks (``apply``'s; a test injects the JAX package's); :param
        row_mask: optional (B,) 1 where a row is real (a padded eval tail):
        the means are over real rows, and the metrics carry their ``weight``."""
        score, md, loc = batch_data
        if train and self.gaussian_reg_coeff > 0.0:
            weights, (g_acts, c_acts) = self.model.forward_tf(
                params, score, md, loc, train=True, generator=self.generator, masks=masks,
                return_activations=True)
            reg = self.gaussian_regularization(list(g_acts) + list(c_acts))
        else:
            weights = self.model.apply(params, score, md, loc, train=train,
                                       generator=self.generator,
                                       coin_generator=self.coin_generator, coin=coin,
                                       masks=masks)
            reg = 0.0
        mask = 1 - loc  # the unconstrained ticks
        if row_mask is not None:
            mask = mask * row_mask[:, None].to(mask.dtype)
        loss = mean_crossentropy_loss(weights, score, mask=mask)
        loss = loss + self.gaussian_reg_coeff * reg
        metrics = {"accuracy": mean_accuracy(weights, score, mask=mask)}
        if row_mask is not None:
            metrics["weight"] = mask.sum()
        return loss, metrics

    @staticmethod
    def gaussian_regularization(activations) -> torch.Tensor:
        """The activations' mean and variance regularizer (reference
        :138-152), in f32: each unit's mean pushed to 0 and its variance
        (``correction=1``) to the layer's mean variance.

        :param activations: a list of per-layer (B, T, H) outputs
        """
        loss_mean, loss_var = 0.0, 0.0
        for h in activations:
            flat = h.float().reshape(-1, h.shape[-1])
            variances = flat.var(dim=0, correction=1)
            loss_mean = loss_mean + (flat.mean(dim=0) ** 2).sum()
            loss_var = loss_var + ((variances - variances.mean()) ** 2).sum()
        return loss_mean + loss_var


class AnticipationRNNBaselineTrainer(AnticipationRNNGaussianRegTrainer):
    constraint_prob = 0.5

    def process_batch_data(self, batch):
        """One scattered mask (reference :201-202): each tick constrained
        with probability p ~ U[0, constraint_prob), shared by the batch."""
        score_tensor = np.asarray(batch[0])
        p = self._np_rng.random_sample() * self.constraint_prob
        single = (self._np_rng.random_sample(score_tensor.shape[1:]) < p).astype(np.int32)
        loc = np.broadcast_to(single[None], score_tensor.shape)
        return self._to_device(score_tensor, np.asarray(batch[1]), loc)
