"""Named dataset registry + DatasetManager.

The port's copy of ``inpaintnet_tpu/data/registry.py``, numpy only: the two must
give the same bytes.

Mirrors reference ``DatasetManager/dataset_manager.py:6-190``: 13 named
configs mapping to (dataset class, corpus config). The corpus root is
configurable (env ``INPAINTNET_CORPUS_DIR`` or argument) instead of being
hardwired to the package directory; a corpus dump can be ingested with
``inpaintnet_tpu_torch.data.corpus.split_raw_dump``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Type

from inpaintnet_tpu_torch.data.corpus import FolkCorpus
from inpaintnet_tpu_torch.data.dataset import (
    FolkDataset,
    FolkDatasetNBars,
    FolkMeasuresDataset,
    FolkMeasuresDatasetTranspose,
    MusicDataset,
)


@dataclass
class DatasetSpec:
    dataset_class: Type[MusicDataset]
    num_elements: Optional[int] = None
    time_sigs: List[Tuple[int, int]] = field(default_factory=lambda: [(4, 4)])


# reference dataset_manager.py:6-119
ALL_DATASETS: Dict[str, DatasetSpec] = {
    "folk": DatasetSpec(FolkDataset, None, [(3, 4), (4, 4)]),
    "folk_test": DatasetSpec(FolkDataset, 10, [(3, 4), (4, 4)]),
    "folk_4by4_test": DatasetSpec(FolkDataset, 100, [(4, 4)]),
    "folk_4by4": DatasetSpec(FolkDataset, None, [(4, 4)]),
    "folk_3by4_test": DatasetSpec(FolkDataset, 100, [(3, 4)]),
    "folk_3by4": DatasetSpec(FolkDataset, None, [(3, 4)]),
    "folk_4by4measures_test": DatasetSpec(FolkMeasuresDataset, 100, [(4, 4)]),
    "folk_4by4measures_test2": DatasetSpec(FolkMeasuresDataset, 1, [(4, 4)]),
    "folk_4by4measures": DatasetSpec(FolkMeasuresDataset, None, [(4, 4)]),
    "folk_4by4measurestr_test": DatasetSpec(FolkMeasuresDatasetTranspose, 1000, [(4, 4)]),
    "folk_4by4measurestr": DatasetSpec(FolkMeasuresDatasetTranspose, None, [(4, 4)]),
    "folk_4by4nbars_short": DatasetSpec(FolkDatasetNBars, 10, [(4, 4)]),
    "folk_4by4nbars": DatasetSpec(FolkDatasetNBars, None, [(4, 4)]),
    "folk_4by4nbars_train": DatasetSpec(FolkDatasetNBars, None, [(4, 4)]),
}


def default_corpus_dir() -> str:
    return os.environ.get(
        "INPAINTNET_CORPUS_DIR",
        os.path.join(os.getcwd(), "dataset_cache", "raw_data"),
    )


class DatasetManager:
    """Name -> dataset factory with on-disk caching
    (reference dataset_manager.py:122-190; caching itself lives in
    ``MusicDataset.arrays``)."""

    def __init__(self, cache_dir: Optional[str] = None, corpus_dir: Optional[str] = None):
        self.cache_dir = cache_dir or os.path.join(os.getcwd(), "dataset_cache")
        self.corpus_dir = corpus_dir or default_corpus_dir()
        os.makedirs(self.cache_dir, exist_ok=True)

    def get_dataset(self, name: str, **dataset_kwargs) -> MusicDataset:
        if name not in ALL_DATASETS:
            raise ValueError(
                f"Dataset {name!r} is not registered; known: {sorted(ALL_DATASETS)}"
            )
        spec = ALL_DATASETS[name]
        corpus = FolkCorpus(
            raw_dir=self.corpus_dir,
            num_elements=spec.num_elements,
            time_sigs=spec.time_sigs,
            cache_dir=self.cache_dir,
        )
        kwargs = dict(dataset_kwargs)
        kwargs.setdefault("cache_dir", self.cache_dir)
        return spec.dataset_class(name=name, corpus_it_gen=corpus, **kwargs)
