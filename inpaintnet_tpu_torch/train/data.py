"""An in-memory dataset of token arrays with the data layer's loaders
(``data/dataset.py`` ``BatchIterator`` and ``MusicDataset.data_loaders``),
for the port's trainers.

The trainers are duck-typed over any object with
``data_loaders(batch_size, split, seed)`` and ``n_bars``: the data layer's
``FolkDatasetNBars`` is one, ``ArrayDataset`` over its arrays is another,
and the two give the same batches. The split is the contiguous one; train
batches are reshuffled every pass from ``seed + pass`` and drop the tail,
eval batches keep it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from inpaintnet_tpu_torch.data.dataset import BatchIterator


class ArrayDataset:
    """Token arrays held in memory: ``arrays[0]`` is (N, 1, n_bars * 24)
    windows, as ``FolkDatasetNBars.arrays`` holds them."""

    def __init__(self, arrays: Sequence[np.ndarray], n_bars: int):
        self.arrays = tuple(arrays)
        self.n_bars = n_bars

    def data_loaders(self, batch_size: int, split=(0.85, 0.10), seed: int = 0):
        """-> (train, val, test) iterators over a contiguous split."""
        if sum(split) >= 1:
            raise ValueError(f"split {split} leaves no test share")
        n = self.arrays[0].shape[0]
        i1, i2 = int(split[0] * n), int((split[0] + split[1]) * n)
        parts = [tuple(a[lo:hi] for a in self.arrays) for lo, hi in ((0, i1), (i1, i2), (i2, n))]
        return (BatchIterator(parts[0], batch_size, shuffle=True, seed=seed),
                BatchIterator(parts[1], batch_size, drop_last=False),
                BatchIterator(parts[2], batch_size, drop_last=False))
