"""LatentRNN tester and its inpainting entry points
(``inpaintnet_tpu/eval/latent_rnn_tester.py``; reference
LatentRNN/latent_rnn_tester.py:13-414).

The product-level contract, *(tensor_score, time_index_range_ticks) ->
inpainted score and tensor*, is :meth:`LatentRNNTester.generation`; every
entry point funnels into :meth:`LatentRNNTester.generate`, which pads the
contexts into the model's fixed buffers and runs one forward.

The splits come from ``numpy.random.RandomState(seed + 41)``, as the JAX
package draws them, so both packages cut the same ones. The forward runs
on the model's device: the frozen encoder on K1 and the argmax decode on K2
where the VAE's geometry takes them. The rsample noise of batch ``i`` (and
of an autoregressive model's re-encodes) comes from a CPU generator seeded
by (``seed``, ``i``) (``ops.distributions.seeded_normal``), the same on the
card and on the CPU; ``noise=`` replaces it (a test passes the JAX
package's draws).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from inpaintnet_tpu_torch.data.tokenizer import END_SYMBOL, REST, START_SYMBOL
from inpaintnet_tpu_torch.eval.vae_tester import mean_of_batches, to_device
from inpaintnet_tpu_torch.ops.distributions import seeded_normal
from inpaintnet_tpu_torch.train.latent_rnn_trainer import (
    pack_padded,
    split_score,
    split_to_measures,
    target_tick_mask,
)
from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss


class LatentRNNTester:
    def __init__(self, dataset, model, seed: int = 0):
        self.dataset = dataset
        self.model = model
        self.device = next(model.parameters()).device
        self.min_num_measures_target = 1
        self.max_num_measure_target = 4
        self.measure_seq_len = self.dataset.subdivision * self.dataset.num_beats_per_bar
        self.max_context = dataset.n_bars
        self.seed = seed
        self._np_rng = np.random.RandomState(seed + 41)

    # --- the forward ---------------------------------------------------------- #
    def noise(self, index: int, batch: int) -> dict:
        """The rsample noise of a packed batch of ``batch`` rows: ``eps``
        of the past and future buffers' measures and, for an
        autoregressive model, ``eps_steps`` of its re-encodes."""
        z = self.model.z_dim
        rows = batch * 2 * self.max_context
        steps = self.model.max_target - 1 if self.model.auto_reg else 0
        eps = seeded_normal(self.seed, index, (rows + steps * batch, z), self.device)
        out = {"eps": eps[:rows]}
        if steps:
            out["eps_steps"] = eps[rows:].reshape(steps, batch, z)
        return out

    def forward(self, packed, noise: dict):
        """The inference forward (JAX's ``_fwd``) of one packed split
        (:func:`pack_padded`'s six numpy arrays) with the noise keywords
        ``noise``. -> (weights (B, Mt, 24, V), samples (B, Mt, 24), gen_z)
        on the device"""
        past, pm, future, fm, target, tm = (to_device(a, self.device) for a in packed)
        noise = {k: torch.as_tensor(v).to(self.device) for k, v in noise.items()}
        with torch.inference_mode():
            return self.model.apply(self.model.params(), self.model.vae_model.params(), past,
                                    future, target, past_mask=pm, future_mask=fm,
                                    target_mask=tm, **noise)

    # --- eval ---------------------------------------------------------------- #
    def test_model(self, batch_size: int = 512):
        _, _, gen_test = self.dataset.data_loaders(batch_size=batch_size, split=(0.01, 0.01))
        print("Num Test Batches: ", len(gen_test))
        mean_loss, mean_acc = self.loss_and_acc_test(gen_test)
        print("Test Epoch: 1/1")
        print(f"\tTest Loss: {mean_loss}\tTest Accuracy: {mean_acc * 100} %")
        return mean_loss, mean_acc

    def loss_and_acc_test(self, data_loader, noise: Optional[Sequence[dict]] = None):
        """Inpainting NLL and accuracy over the valid target measures of a
        random split of each batch.

        :param noise: optional sequence, one dict of :meth:`noise`'s keys a
            batch, in place of the tester's draws
        """
        losses, accs = [], []
        with torch.inference_mode():
            for i, batch in enumerate(data_loader):
                packed = self.process_batch_data(batch)
                weights, _, _ = self.forward(
                    packed, noise[i] if noise is not None else self.noise(i, packed[0].shape[0]))
                target = to_device(packed[4], self.device)
                tick_mask = target_tick_mask(to_device(packed[5], self.device),
                                             self.measure_seq_len)
                losses.append(mean_crossentropy_loss(weights, target, mask=tick_mask))
                accs.append(mean_accuracy(weights, target, mask=tick_mask))
        return mean_of_batches(losses, accs)

    def process_batch_data(self, batch):
        return self.split_score_stochastic(np.asarray(batch[0]))

    def split_score_stochastic(self, score_tensor, fix_num_target: Optional[int] = None):
        """A random split of (B, 1, seq) windows into past, target (1 to 4
        measures, or ``fix_num_target``) and future, packed
        (:func:`pack_padded`)."""
        m = split_to_measures(score_tensor, self.measure_seq_len)
        num_measures = m.shape[1]
        num_target = (fix_num_target if fix_num_target is not None
                      else int(self._np_rng.randint(self.min_num_measures_target,
                                                    self.max_num_measure_target + 1)))
        num_past = int(self._np_rng.randint(1, num_measures - num_target - 1))
        num_future = num_measures - num_past - num_target
        past, future, target = split_score(score_tensor, num_past, num_future, num_target,
                                           self.measure_seq_len)
        return pack_padded(past, future, target, self.max_context, self.model.max_target)

    # --- generation ------------------------------------------------------------ #
    def generation_test(self):
        """Inpaint a random test window."""
        _, _, gen_test = self.dataset.data_loaders(batch_size=1, split=(0.70, 0.20))
        it = iter(gen_test)
        # skip a random number of batches, then take the next one
        for _ in range(self._np_rng.randint(0, max(1, len(gen_test)))):
            next(it)
        batch = next(it)
        m = split_to_measures(np.asarray(batch[0]), self.measure_seq_len)
        num_target = int(self._np_rng.randint(1, self.max_num_measure_target + 1))
        num_past = int(self._np_rng.randint(1, m.shape[1] - num_target - 1))
        num_future = m.shape[1] - num_past - num_target
        past, future, target = split_score(np.asarray(batch[0]), num_past, num_future,
                                           num_target, self.measure_seq_len)
        return self.generate(past, future, target, num_target)

    def generation_random(self, tensor_score, start_measure, num_measures_gen):
        """Inpainting at a fixed position (``start_measure`` 1-based)."""
        return self._generation_from_tensor(tensor_score, start_measure, num_measures_gen)

    def generation(self, num_iterations=None, sequence_length_ticks: int = 384,
                   tensor_score=None,
                   time_index_range_ticks: Optional[Tuple[int, int]] = None):
        """Tick-range inpainting: regenerate ticks [a, b) of ``tensor_score``
        (a tune of the corpus when None). A range that touches either end
        of the tune returns it unchanged. -> (score, tensor (1, ticks), None)"""
        del num_iterations
        if tensor_score is None:
            score = next(self.dataset.iterator_gen())
            tensor_score, _ = self.dataset.transposed_score_and_metadata_tensors(score, 0)
        # the range is checked against the tensor's own length
        sequence_length_ticks = np.asarray(tensor_score).shape[-1]
        if time_index_range_ticks is None:
            start_measure, num_measures_gen = 8, 2
        else:
            a, b = time_index_range_ticks
            if not (a < b and a % self.measure_seq_len == 0 and b % self.measure_seq_len == 0):
                raise ValueError(f"tick range {time_index_range_ticks}: want a < b, both "
                                 f"multiples of {self.measure_seq_len}")
            start_measure = a // self.measure_seq_len + 1
            num_measures_gen = (b - a) // self.measure_seq_len
            if a <= 0 or b >= sequence_length_ticks:
                return self.dataset.tensor_to_score(tensor_score), tensor_score, None
        gen_score, gen_tensor, _ = self._generation_from_tensor(
            np.asarray(tensor_score), start_measure, num_measures_gen)
        return gen_score, gen_tensor.reshape(1, -1), None

    def _generation_from_tensor(self, tensor_score, start_measure, num_measures_gen):
        tensor_score = np.asarray(tensor_score)
        msl = self.measure_seq_len
        if tensor_score.ndim == 2:
            tensor_score = tensor_score[:, :(tensor_score.shape[1] // msl) * msl][:, None, :]
        m = split_to_measures(tensor_score, msl)
        num_measures = min(self.dataset.n_bars, m.shape[1])
        tensor_score = tensor_score[:, :, :num_measures * msl]
        num_past = start_measure - 1
        num_future = num_measures - num_past - num_measures_gen
        past, future, target = split_score(tensor_score, num_past, num_future,
                                           num_measures_gen, msl)
        return self.generate(past, future, target, num_measures_gen)

    def generate(self, tensor_past, tensor_future, tensor_target, num_target_measures,
                 eval: bool = False, noise: Optional[dict] = None):
        """Inpaint between a past and a future, (B, Mp | Mf, 24) each (None:
        an empty start or end context); ``tensor_target`` (B, Mt, 24) is
        optional, only its length and, with ``eval``, the printed loss read it.

        :param noise: optional noise keywords (:meth:`noise`'s) in place of
            the draw of batch 0 of the tester's seed
        :return: (generated score, generated tensor (B, Mp + Mt + Mf, 24),
            original score or None)
        """
        if tensor_target is not None:
            num_target_measures = tensor_target.shape[1]
        elif num_target_measures is None:
            raise ValueError("num_target_measures required without a target")
        if tensor_past is None:
            tensor_past = self.create_empty_context("start")
        if tensor_future is None:
            tensor_future = self.create_empty_context("end")
        batch = tensor_past.shape[0]
        target_for_pack = (tensor_target if tensor_target is not None else
                           np.zeros((batch, num_target_measures, self.measure_seq_len),
                                    np.int32))
        packed = pack_padded(tensor_past, tensor_future, target_for_pack, self.max_context,
                             self.model.max_target)
        weights, gen_target, _ = self.forward(
            packed, noise if noise is not None else self.noise(0, batch))
        gen_target = gen_target.cpu().numpy()[:, :num_target_measures, :]

        if tensor_target is not None and eval:
            target = to_device(packed[4], self.device)
            tick_mask = target_tick_mask(to_device(packed[5], self.device),
                                         self.measure_seq_len)
            loss = float(mean_crossentropy_loss(weights, target, mask=tick_mask))
            acc = float(mean_accuracy(weights, target, mask=tick_mask))
            print("Accuracy for Test Case:")
            print(f"\tLoss: {loss}\tAccuracy: {acc * 100} %")

        gen_score_tensor = np.concatenate([tensor_past, gen_target, tensor_future], axis=1)
        gen_score = self.dataset.tensor_to_score(gen_score_tensor)
        original_score = None
        if tensor_target is not None:
            original_score = self.dataset.tensor_to_score(
                np.concatenate([tensor_past, tensor_target, tensor_future], axis=1))
        return gen_score, gen_score_tensor, original_score

    def create_empty_context(self, type: str) -> np.ndarray:
        """(1, M, 24) of one symbol: 3 measures of START ("start"), one of
        END ("end") or of rests ("rest")."""
        v = self.dataset.note2index_dicts[0]
        if type == "start":
            num_measures, symbol = 3, v[START_SYMBOL]
        elif type == "end":
            num_measures, symbol = 1, v[END_SYMBOL]
        elif type == "rest":
            num_measures, symbol = 1, v[REST]
        else:
            raise ValueError('Invalid argument "type"')
        return np.full((1, num_measures, self.measure_seq_len), symbol, np.int32)
