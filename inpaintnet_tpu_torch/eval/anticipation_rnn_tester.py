"""AnticipationRNN tester (``inpaintnet_tpu/eval/anticipation_rnn_tester.py``).

Duck-typed over a dataset with ``data_loaders(batch_size, split)`` whose
batches are (score (B, 1, T), metadata (B, 1, T, num_md)), as the JAX
package's ``FolkDatasetNBars`` and ``train.data.ArrayDataset`` over those
two arrays give them; ``tensor_to_score`` is used only where the dataset
has one. The measure length is ``subdivision * num_beats_per_bar`` where
the dataset says so, else 24 ticks.

The inpainting metrics run ``apply_inpaint`` (:meth:`AnticipationRNNTester.inpaint`,
which the joint evaluation ``cli/test_reconstruction.py`` calls too) and
the alternative ones ``apply``: both are the argmax decode, so a 2-layer
model of the kernel's widths runs K7 on the card here too. ``generation``
and ``generation_test`` sample with a temperature.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from inpaintnet_tpu_torch.eval.vae_tester import mean_of_batches
from inpaintnet_tpu_torch.models.measure_vae import NUM_TICKS_PER_MEASURE
from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss


def split_to_measures(score_tensor: np.ndarray, measure_seq_len: int) -> np.ndarray:
    """(B, 1, seq) -> (B, M, measure_seq_len)."""
    b, _, seq_len = score_tensor.shape
    if seq_len % measure_seq_len != 0:
        raise ValueError("sequence length not a multiple of the measure length")
    return score_tensor.reshape(b, -1, measure_seq_len)


class AnticipationRNNTester:
    def __init__(self, dataset, model, seed: int = 0):
        self.dataset = dataset
        self.model = model
        self.device = next(model.parameters()).device  # batches go where the model is
        if hasattr(dataset, "subdivision") and hasattr(dataset, "num_beats_per_bar"):
            self.measure_seq_len = dataset.subdivision * dataset.num_beats_per_bar
        else:
            self.measure_seq_len = NUM_TICKS_PER_MEASURE
        self.min_num_measures_target = 2
        self.max_num_measure_target = 6
        self.seed = seed
        self._np_rng = np.random.RandomState(seed + 53)

    def _to_device(self, *arrays):
        return [torch.as_tensor(a).to(self.device) for a in arrays]

    # --- eval -------------------------------------------------------------- #
    def test_model(self, batch_size: int = 512):
        _, _, gen_test = self.dataset.data_loaders(batch_size=batch_size, split=(0.01, 0.01))
        print("Num Test Batches: ", len(gen_test))
        mean_loss, mean_acc = self.loss_and_acc_test(gen_test)
        print("Test Epoch: 1/1")
        print(f"\tTest Loss: {mean_loss}\tTest Accuracy: {mean_acc * 100} %")
        return mean_loss, mean_acc

    def inpaint(self, score, md, loc):
        """The inpainting decode (JAX's ``_inpaint``) of numpy or device
        (score (B, T), metadata (B, T, num_md), constraints_loc (B, T)):
        the constrained ticks forced, the rest by argmax. -> (logits
        (B, T, V), tokens (B, T)) on the device"""
        with torch.inference_mode():
            return self.model.apply_inpaint(self.model.params(),
                                            *self._to_device(score, md, loc))

    def loss_and_acc_test(self, data_loader):
        """Inpainting NLL and accuracy on the unconstrained span."""
        losses, accs = [], []
        with torch.inference_mode():
            for batch in data_loader:
                score, md, loc = self._to_device(*self.process_batch_data(batch))
                logits, _ = self.inpaint(score, md, loc)
                mask = 1 - loc
                losses.append(mean_crossentropy_loss(logits, score, mask=mask))
                accs.append(mean_accuracy(logits, score, mask=mask))
        return mean_of_batches(losses, accs)

    def loss_and_acc_test_alt(self, data_loader):
        """Single-tick NLL and accuracy near the sequence's middle, from the
        decode with nothing forced."""
        params = self.model.params()
        mean_loss, mean_acc, nb = 0.0, 0.0, 0
        with torch.inference_mode():
            for batch in data_loader:
                score, md, loc = self._to_device(*self.process_batch_data(batch))
                logits = self.model.apply(params, score, md, loc)
                t = score.shape[1] // 2 + int(self._np_rng.randint(-5, 5))
                mean_loss += float(mean_crossentropy_loss(logits[:, t], score[:, t]))
                mean_acc += float(mean_accuracy(logits[:, t], score[:, t]))
                nb += 1
        nb = max(nb, 1)
        return mean_loss / nb, mean_acc / nb

    def process_batch_data(self, batch):
        """-> (score (B, T), metadata (B, T, num_md), constraints_loc (B, T)),
        int32 numpy."""
        score_tensor = np.asarray(batch[0])
        metadata_tensor = np.asarray(batch[1])
        loc, _, _ = self.get_constraints_location(score_tensor)
        b = score_tensor.shape[0]
        score = score_tensor.reshape(b, -1).astype(np.int32)
        md = metadata_tensor.reshape(b, score.shape[1], -1).astype(np.int32)
        return score, md, loc.reshape(b, -1).astype(np.int32)

    def get_constraints_location(self, score_tensor, stochastic: bool = False,
                                 start_measure: int = 8, num_measures: int = 2,
                                 fix_num_target: Optional[int] = None):
        """Deterministic or stochastic constraint placement (defaults: start
        measure 8, 2 measures). -> (loc like ``score_tensor``, start tick,
        end tick)"""
        m = split_to_measures(score_tensor, self.measure_seq_len)
        total = m.shape[1]
        if stochastic:
            num_measures = (fix_num_target if fix_num_target is not None
                            else int(self._np_rng.randint(self.min_num_measures_target,
                                                          self.max_num_measure_target + 1)))
            start_measure = int(self._np_rng.randint(1, total - num_measures - 1)) + 1
        loc = np.zeros_like(score_tensor)
        start_tick = start_measure * self.measure_seq_len
        end_tick = start_tick + num_measures * self.measure_seq_len
        if start_tick > 0:
            loc[..., :start_tick] = 1
        if end_tick < loc.shape[-1] - 1:
            loc[..., end_tick:] = 1
        return loc, start_tick, end_tick

    # --- generation --------------------------------------------------------- #
    def generation_test(self, temperature: float = 1.5):
        """Inpaint the first test window at the default constraint place."""
        _, _, gen_test = self.dataset.data_loaders(batch_size=1, split=(0.70, 0.20))
        score, md, loc = self.process_batch_data(next(iter(gen_test)))
        return self.generation_from_tensor(score, md, loc, temperature)

    def generation(self, tensor_score=None, tensor_metadata=None, start_measure: int = 8,
                   num_measures_gen: int = 2, temperature: float = 1.5):
        """Regenerate ``num_measures_gen`` measures from ``start_measure``
        (0-based) of a tune ((1, T) tokens and (T, num_md) metadata; the
        corpus's first tune, cut to at most ``n_bars`` measures, when None)."""
        if tensor_score is None:
            score = next(self.dataset.iterator_gen())
            st, mt = self.dataset.get_score_tensor(score), self.dataset.get_metadata_tensor(score)
            n = min(self.dataset.n_bars, st.shape[1] // self.measure_seq_len)
            tensor_score = st[:, :n * self.measure_seq_len]
            tensor_metadata = mt[:n * self.measure_seq_len]
        score = np.asarray(tensor_score).reshape(1, -1).astype(np.int32)
        md = np.asarray(tensor_metadata).reshape(1, score.shape[1], -1).astype(np.int32)
        loc, _, _ = self.get_constraints_location(score[:, None, :], start_measure=start_measure,
                                                  num_measures=num_measures_gen)
        return self.generation_from_tensor(score, md, loc.reshape(1, -1), temperature)

    def generation_from_tensor(self, score, md, loc, temperature: float = 1.5):
        """Temperature sampling of the unconstrained ticks, with noise from a
        generator seeded with the tester's seed. -> (the generated score, or
        None where the dataset has no ``tensor_to_score``; the generated
        tokens (B, T); the original score or None)"""
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        with torch.inference_mode():
            _, gen = self.model.generate(self.model.params(), *self._to_device(score, md, loc),
                                         temperature=temperature, generator=generator)
        gen = gen.cpu().numpy()
        if not hasattr(self.dataset, "tensor_to_score"):
            return None, gen, None
        return (self.dataset.tensor_to_score(gen[0]), gen,
                self.dataset.tensor_to_score(np.asarray(score)[0]))
