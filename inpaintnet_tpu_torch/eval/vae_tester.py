"""MeasureVAE tester (``inpaintnet_tpu/eval/vae_tester.py``; reference
MeasureVAE/vae_tester.py:17-331): test-set NLL and accuracy, latent
interpolation, latent-space probes.

Batches go to the model's device; a 2-layer model of the kernels' widths
runs K1 (the encoder) and K2 (the argmax decode) there. The rsample noise
of batch ``i`` comes from a CPU generator seeded by (``seed``, ``i``)
(``ops.distributions.seeded_normal``), so a run on the card and a run on
the CPU draw the same noise; ``noise=`` replaces it (a test passes the JAX
package's draws).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from inpaintnet_tpu_torch.data.tokenizer import END_SYMBOL, START_SYMBOL
from inpaintnet_tpu_torch.ops.distributions import seeded_normal
from inpaintnet_tpu_torch.train.metrics import mean_accuracy, mean_crossentropy_loss


def to_device(array, device) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def mean_of_batches(losses: list, accs: list):
    """(mean loss, mean accuracy) of per-batch device scalars, summed as
    Python floats in batch order (the JAX testers' sums), one device sync."""
    nb = max(len(losses), 1)
    if not losses:
        return 0.0, 0.0
    loss_values, acc_values = torch.stack(losses).tolist(), torch.stack(accs).tolist()
    return sum(loss_values) / nb, sum(acc_values) / nb


class VAETester:
    def __init__(self, dataset, model, seed: int = 0):
        self.dataset = dataset
        self.model = model
        self.device = next(model.parameters()).device
        self.z_dim = model.latent_space_dim
        self.measure_seq_len = 24
        self.seed = seed

    # --- eval ------------------------------------------------------------- #
    def _measure_batch(self, score_tensor: np.ndarray) -> np.ndarray:
        n_bars = getattr(self.dataset, "n_bars", None)
        b = score_tensor.shape[0]
        if n_bars is not None:
            return score_tensor.reshape(b * n_bars, -1).astype(np.int32)
        return score_tensor.reshape(b, -1).astype(np.int32)

    def noise(self, index: int, rows: int) -> dict:
        """Batch ``index``'s rsample noise for ``rows`` measures."""
        return {"eps": seeded_normal(self.seed, index, (rows, self.z_dim), self.device)}

    def test_model(self, batch_size: int = 64):
        _, _, gen_test = self.dataset.data_loaders(batch_size=batch_size, split=(0.01, 0.01))
        print("Num Test Batches: ", len(gen_test))
        mean_loss, mean_acc = self.loss_and_acc_test(gen_test)
        print("Test Epoch:")
        print("\tTest Loss: ", mean_loss, "\n\tTest Accuracy: ", mean_acc * 100)
        return mean_loss, mean_acc

    def loss_and_acc_test(self, data_loader, noise: Optional[Sequence[dict]] = None):
        """Reconstruction NLL and accuracy, one measure a row.

        :param noise: optional sequence, one ``{"eps": (rows, z)}`` a batch,
            in place of the tester's draws
        """
        params = self.model.params()
        losses, accs = [], []
        with torch.inference_mode():
            for i, batch in enumerate(data_loader):
                score = to_device(self._measure_batch(np.asarray(batch[0])), self.device)
                eps = (noise[i] if noise is not None else self.noise(i, score.shape[0]))["eps"]
                weights = self.model.apply(params, score, train=False,
                                           eps=torch.as_tensor(eps).to(self.device))[0]
                losses.append(mean_crossentropy_loss(weights, score))
                accs.append(mean_accuracy(weights, score))
        return mean_of_batches(losses, accs)

    def loss_and_acc_test_alt(self, data_loader, noise: Optional[Sequence[dict]] = None):
        """The same metrics through ``apply_test``, the measures of a window
        grouped; ``noise`` as :meth:`loss_and_acc_test`."""
        params = self.model.params()
        losses, accs = [], []
        with torch.inference_mode():
            for i, batch in enumerate(data_loader):
                score = np.asarray(batch[0])
                score = to_device(score.reshape(score.shape[0], -1, 24).astype(np.int32),
                                  self.device)
                rows = score.shape[0] * score.shape[1]
                eps = (noise[i] if noise is not None else self.noise(i, rows))["eps"]
                weights, _ = self.model.apply_test(params, score,
                                                   eps=torch.as_tensor(eps).to(self.device))
                losses.append(mean_crossentropy_loss(weights, score))
                accs.append(mean_accuracy(weights, score))
        return mean_of_batches(losses, accs)

    # --- interpolation ------------------------------------------------------ #
    def decode_mid_point(self, z1: torch.Tensor, z2: torch.Tensor, n: int) -> np.ndarray:
        """Decode z1, ``n`` interpolants and z2 -> (1, (n + 2) * 24) tokens."""
        if not isinstance(n, int) or n < 1:
            raise ValueError(f"n must be a positive int, got {n!r}")
        alphas = (torch.arange(0, n + 2, device=z1.device) / (n + 1))[:, None]
        zs = z1[None, :] * (1 - alphas) + z2[None, :] * alphas
        with torch.inference_mode():
            _, samples = self.model.decoder.decode_sampling(self.model.params()["decoder"], zs)
        return samples.cpu().numpy().reshape(1, -1)

    def _encode(self, tokens) -> torch.Tensor:
        """(rows, 24) tokens -> the posterior means (rows, z)."""
        with torch.inference_mode():
            return self.model.encoder.apply(self.model.params()["encoder"],
                                            to_device(np.asarray(tokens, np.int32),
                                                      self.device)).loc

    def test_interpolation(self, tensor_score1, tensor_score2, n: int = 1):
        """Encode two measures' means, decode the path between them; -> the
        stitched Score."""
        z1 = self._encode(tensor_score1)[0]
        z2 = self._encode(tensor_score2)[0]
        return self.dataset.tensor_to_score(self.decode_mid_point(z1, z2, n))

    def test_interp(self, n: int = 10):
        _, gen_val, gen_test = self.dataset.data_loaders(batch_size=1, split=(0.01, 0.5))
        s1 = self._measure_batch(np.asarray(next(iter(gen_test))[0]))[:1]
        s2 = self._measure_batch(np.asarray(next(iter(gen_val))[0]))[:1]
        return self.test_interpolation(s1, s2, n)

    # --- latent-space probes ------------------------------------------------- #
    def encode_test_set(self, batch_size: int = 64, num_batches: int = 6,
                        attribute: str = "num_notes"):
        """Latent means and attribute values over test batches. -> (z
        (N, z_dim), attributes (N,)), numpy"""
        _, _, gen_test = self.dataset.data_loaders(batch_size=batch_size, split=(0.70, 0.20))
        probes = {"num_notes": self.dataset.get_num_notes_in_measure,
                  "note_range": self.dataset.get_note_range_of_measure,
                  "rhy_entropy": self.dataset.get_rhythmic_entropy,
                  "beat_strength": self.dataset.get_beat_strength}
        if attribute not in probes:
            raise ValueError("Invalid attribute type")
        z_all, n_all = [], []
        start_idx = self.dataset.note2index_dicts[0][START_SYMBOL]
        end_idx = self.dataset.note2index_dicts[0][END_SYMBOL]
        for i, batch in enumerate(gen_test):
            if i > num_batches:
                break
            score = self._measure_batch(np.asarray(batch[0]))
            z = self._encode(score).cpu().numpy()
            attr = np.asarray(probes[attribute](score)).copy()
            attr[score[:, 0] == start_idx] = -0.1
            attr[score[:, 0] == end_idx] = -0.2
            z_all.append(z)
            n_all.append(attr)
        return np.concatenate(z_all), np.concatenate(n_all)

    def plot_attribute_dist(self, attribute="num_notes", plt_type="pca", out_dir="plots"):
        """PCA or t-SNE scatter of the latent means by an attribute, saved
        to ``out_dir``. -> the PNG's path"""
        z_all, n_all = self.encode_test_set(attribute=attribute)
        os.makedirs(out_dir, exist_ok=True)
        filename = os.path.join(out_dir, f"{plt_type}_{attribute}_measure_vae.png")
        self._plot_projection(z_all, n_all, filename, plt_type)
        return filename

    def plot_transposition_points(self, plt_type="pca", out_dir="plots"):
        """The latent means of one tune's measures in every transposition.
        -> the PNG's path"""
        score = next(self.dataset.iterator_gen())
        z_all, n_all = [], []
        for semi in self.dataset.all_transposition_intervals(score):
            st, _ = self.dataset.transposed_score_and_metadata_tensors(score, semi)
            z = self._encode(self.dataset.split_score_tensor_to_measures(st)).cpu().numpy()
            z_all.append(z)
            n_all.append(np.arange(z.shape[0]))
        os.makedirs(out_dir, exist_ok=True)
        filename = os.path.join(out_dir, f"{plt_type}_transposition_measure_vae.png")
        self._plot_projection(np.concatenate(z_all), np.concatenate(n_all), filename, plt_type)
        return filename

    @staticmethod
    def _plot_projection(data, target, filename, plt_type="pca"):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if plt_type == "pca":
            from sklearn.decomposition import PCA

            proj = PCA(n_components=2, whiten=False).fit_transform(data)
        elif plt_type == "tsne":
            from sklearn.manifold import TSNE

            proj = TSNE(n_components=2,
                        perplexity=min(40, max(5, len(data) // 4))).fit_transform(data)
        else:
            raise ValueError("Invalid plot type")
        plt.figure()
        plt.scatter(x=proj[:, 0], y=proj[:, 1], c=target, cmap="viridis", alpha=0.3)
        plt.colorbar()
        plt.savefig(filename, format="png", dpi=150)
        plt.close()
