from inpaintnet_tpu_torch.data.score import Note, Pitch, Score
from inpaintnet_tpu_torch.data.abc_parser import parse_abc, AbcParseError
from inpaintnet_tpu_torch.data.tokenizer import (
    SLUR_SYMBOL,
    START_SYMBOL,
    END_SYMBOL,
    OUT_OF_RANGE,
    PAD_SYMBOL,
    REST,
    SUBDIVISION,
    TICK_VALUES,
    TICK_DURATIONS,
    Vocabulary,
    score_to_tensor,
    tensor_to_score,
    all_transposition_semitones,
)
from inpaintnet_tpu_torch.data.metadata import (
    Metadata,
    TickMetadata,
    BeatMarkerMetadata,
    IsPlayingMetadata,
    metadata_tensor,
)
from inpaintnet_tpu_torch.data.corpus import FolkCorpus, split_raw_dump
from inpaintnet_tpu_torch.data.dataset import (
    MusicDataset,
    FolkDataset,
    FolkMeasuresDataset,
    FolkMeasuresDatasetTranspose,
    FolkDatasetNBars,
    BatchIterator,
)
from inpaintnet_tpu_torch.data.registry import DatasetManager, ALL_DATASETS
