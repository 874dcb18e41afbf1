"""LatentRNN (InpaintNet) trainer (``inpaintnet_tpu/train/latent_rnn_trainer.py``).

Each batch of windows splits at random into past, target (2 to 6 measures)
and future, drawn on the host from ``numpy.random.RandomState(seed + 17)``
as the JAX package draws them (so a split is bit-equal to its), then packs
into fixed-size padded buffers with validity masks: every step does the
same work whatever the split.

The loss is the cross-entropy of the target's ticks, masked to its valid
measures, in f32; the frozen MeasureVAE's parameters are the trainer's
``extra`` (``train/trainer.py``). On the card a training step runs the
frozen encoder on K5 (train mode, dropout on), the argmax decode on K2 with
the eager scan's backward, the masked context and generation GRUs as
eager loops, and on the autoregressive sampled branch the unmasked
generation GRU on K5 / K6 at any width (1,536 units at
``--latent_rnn_hidden_size 768``: tile groups that span clusters); the
validation pass runs the serving routes (K1, K2).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss
from inpaintnet_tpu_torch.train.trainer import Trainer


def split_to_measures(score_tensor: np.ndarray, measure_seq_len: int) -> np.ndarray:
    """(B, 1, seq) -> (B, M, measure_seq_len)."""
    b, _, seq_len = score_tensor.shape
    if seq_len % measure_seq_len != 0:
        raise ValueError("sequence length not a multiple of the measure length")
    return score_tensor.reshape(b, -1, measure_seq_len)


def split_score(score_tensor, num_past: int, num_future: int, num_target: int,
                measure_seq_len: int):
    """Past, future and target measures of (B, 1, seq) windows:
    (B, num_past | num_future | num_target, measure_seq_len) each."""
    m = split_to_measures(np.asarray(score_tensor), measure_seq_len)
    num_measures = m.shape[1]
    if num_measures != num_past + num_future + num_target:
        raise ValueError(f"{num_measures} measures, split {num_past}/{num_target}/{num_future}")
    past = m[:, :num_past]
    future = m[:, num_measures - num_future:]
    target = m[:, num_past:num_measures - num_future]
    return past, future, target


def pack_padded(past, future, target, max_context: int,
                max_target: int) -> Tuple[np.ndarray, ...]:
    """Pad (past, future, target) into fixed int32 buffers with f32 masks:
    -> (past, past_mask, future, future_mask, target, target_mask)."""
    b, msl = past.shape[0], past.shape[-1]

    def pad(x, n):
        buf = np.zeros((b, n, msl), dtype=np.int32)
        buf[:, :x.shape[1]] = x
        mask = np.zeros((b, n), dtype=np.float32)
        mask[:, :x.shape[1]] = 1.0
        return buf, mask

    return (*pad(past, max_context), *pad(future, max_context), *pad(target, max_target))


def target_tick_mask(target_mask: torch.Tensor, measure_seq_len: int) -> torch.Tensor:
    """(B, Mt) target validity -> (B, Mt, measure_seq_len): every tick of a
    valid target measure counts, no tick of a padded one."""
    return target_mask[:, :, None].expand(-1, -1, measure_seq_len)


class LatentRNNTrainer(Trainer):
    min_num_measures_target = 2
    max_num_measure_target = 6

    def __init__(self, dataset, model, lr: float = 1e-4, early_stopping: bool = False, **kw):
        # the split draws num_past from [1, n_bars - num_target - 1), a
        # range that is empty for the largest target below this
        if dataset.n_bars < self.max_num_measure_target + 3:
            raise ValueError(f"n_bars {dataset.n_bars} too small for max target "
                             f"{self.max_num_measure_target} (need >= target + 3)")
        super().__init__(dataset, model, lr, early_stopping, **kw)
        self.measure_seq_len = model.measure_seq_len
        self.max_context = dataset.n_bars
        self._np_rng = np.random.RandomState(kw.get("seed", 0) + 17)

    def extra_params(self):
        return self.model.vae_model.params()

    # --- batch prep ---------------------------------------------------------- #
    def process_batch_data(self, batch):
        """(B, 1, n_bars * 24) windows -> the padded split as tensors on the
        trainer's device (:func:`pack_padded`'s order)."""
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in self.split_score_stochastic(np.asarray(batch[0])))

    def split_score_stochastic(self, score_tensor: np.ndarray, extra_outs: bool = False,
                               fix_num_target: Optional[int] = None):
        """A random split of the windows, packed (numpy); with
        ``extra_outs`` also -> num_past, num_target."""
        m = split_to_measures(score_tensor, self.measure_seq_len)
        num_measures = m.shape[1]
        if num_measures != self.dataset.n_bars:
            raise ValueError(f"{num_measures} measures a window, dataset has "
                             f"{self.dataset.n_bars} bars")
        if fix_num_target is None:
            num_target = int(self._np_rng.randint(self.min_num_measures_target,
                                                  self.max_num_measure_target + 1))
        else:
            num_target = fix_num_target
        num_past = int(self._np_rng.randint(1, num_measures - num_target - 1))
        num_future = num_measures - num_past - num_target
        packed = pack_padded(*split_score(score_tensor, num_past, num_future, num_target,
                                          self.measure_seq_len),
                             self.max_context, self.max_num_measure_target)
        if extra_outs:
            return packed, num_past, num_target
        return packed

    # --- loss ---------------------------------------------------------------- #
    def loss_and_metrics(self, params, batch_data, train: bool, extra=None,
                         eps: Optional[torch.Tensor] = None,
                         eps_steps: Optional[torch.Tensor] = None, coin: Optional[bool] = None,
                         row_mask: Optional[torch.Tensor] = None):
        """:param extra: the frozen VAE's parameters; :param eps,
        eps_steps, coin: optional rsample noise and teacher-forcing coin
        (``LatentRNN.apply``'s; a test injects the JAX package's); :param
        row_mask: optional (B,) 1 where a row is real (a padded eval tail):
        the means are over real rows, and the metrics carry their ``weight``."""
        past, pm, future, fm, target, tm = batch_data
        weights, _, _ = self.model.apply(
            params, extra, past, future, target, past_mask=pm, future_mask=fm, target_mask=tm,
            train=train, generator=self.generator, coin_generator=self.coin_generator,
            coin=coin, eps=eps, eps_steps=eps_steps)
        tick_mask = target_tick_mask(tm, self.measure_seq_len)
        if row_mask is not None:
            tick_mask = tick_mask * row_mask[:, None, None].to(tick_mask.dtype)
        loss = mean_crossentropy_loss(weights, target, mask=tick_mask)
        metrics = {"accuracy": mean_accuracy(weights, target, mask=tick_mask)}
        if row_mask is not None:
            metrics["weight"] = tick_mask.sum()
        return loss, metrics
