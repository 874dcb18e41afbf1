"""Per-tick metadata feature generators.

The port's copy of ``inpaintnet_tpu/data/metadata.py``, numpy only: the two must
give the same bytes.

Mirrors reference ``DatasetManager/metadata.py`` over the Score IR. All
``evaluate`` methods return int arrays of shape ``(length,)`` where
``length = highest_time * subdivision``.

NOTE on BeatMarkerMetadata: the reference implementation has a slicing bug
(metadata.py:157-165): it builds ``t`` with shape ``(1, length)`` and then
assigns ``t[0::freq] = ...`` which slices ROWS, so only ``t[0]`` is ever
assigned and the produced channel is the constant DOWNBEAT index. This
rebuild implements the *intended* semantics (downbeat marker on tick 0 of
each measure, beat marker on each other beat, slur elsewhere). Set
``replicate_reference_bug=True`` to reproduce the constant channel for
byte-level parity experiments.
"""
from __future__ import annotations

import numpy as np

from inpaintnet_tpu_torch.data.score import Score
from inpaintnet_tpu_torch.data.tokenizer import (
    BEAT_SYMBOL,
    DOWNBEAT_SYMBOL,
    PAD_SYMBOL,
    SLUR_SYMBOL,
    SUBDIVISION,
)


class Metadata:
    name: str = ""
    num_values: int = 0

    def evaluate(self, score: Score, subdivision: int) -> np.ndarray:
        raise NotImplementedError

    def generate(self, length: int) -> np.ndarray:
        raise NotImplementedError


class TickMetadata(Metadata):
    """Position-within-beat counter, values 0..subdivision-1
    (reference metadata.py:81-111)."""

    def __init__(self, subdivision: int = SUBDIVISION):
        self.num_values = subdivision
        self.name = "tick"

    def evaluate(self, score: Score, subdivision: int) -> np.ndarray:
        assert subdivision == self.num_values
        length = int(score.highest_time * subdivision)
        return self.generate(length)

    def generate(self, length: int) -> np.ndarray:
        return np.arange(length, dtype=np.int64) % self.num_values


class BeatMarkerMetadata(Metadata):
    """Beat / downbeat markers with a 4-symbol dictionary
    (reference metadata.py:114-180; see module docstring for the bug fix).

    Symbol order is fixed (sorted) for determinism — the reference iterates
    a set (metadata.py:126-133)."""

    def __init__(self, subdivision: int = SUBDIVISION, replicate_reference_bug: bool = False):
        self.num_values = subdivision
        self.name = "beatmarker"
        self.subdivision = subdivision
        self.replicate_reference_bug = replicate_reference_bug
        symbols = sorted([PAD_SYMBOL, SLUR_SYMBOL, BEAT_SYMBOL, DOWNBEAT_SYMBOL])
        self.beat_index2symbol_dicts = {i: s for i, s in enumerate(symbols)}
        self.beat_symbol2index_dicts = {s: i for i, s in enumerate(symbols)}

    def evaluate(self, score: Score, subdivision: int) -> np.ndarray:
        assert subdivision == self.num_values
        beats_per_measure = score.time_signature[0]
        assert beats_per_measure in (3, 4)
        length = int(score.highest_time * subdivision)
        return self._sequence(length, beats_per_measure)

    def generate(self, length: int) -> np.ndarray:
        return self._sequence(length, beats_per_measure=4)

    def _sequence(self, length: int, beats_per_measure: int) -> np.ndarray:
        s2i = self.beat_symbol2index_dicts
        if self.replicate_reference_bug:
            return np.full((length,), s2i[DOWNBEAT_SYMBOL], dtype=np.int64)
        freq = beats_per_measure * self.subdivision
        t = np.full((length,), s2i[SLUR_SYMBOL], dtype=np.int64)
        t[0::freq] = s2i[DOWNBEAT_SYMBOL]
        for beat in range(1, beats_per_measure):
            t[beat * self.subdivision :: freq] = s2i[BEAT_SYMBOL]
        return t


class IsPlayingMetadata(Metadata):
    """1 where a voice is sounding; rests of at least ``min_num_ticks``
    mark 0 (reference metadata.py:33-78)."""

    def __init__(self, min_num_ticks: int):
        self.min_num_ticks = min_num_ticks
        self.num_values = 2
        self.name = "isplaying"

    def evaluate(self, score: Score, subdivision: int) -> np.ndarray:
        from inpaintnet_tpu_torch.data.tokenizer import offset_to_tick

        length = int(score.highest_time * subdivision)
        out = np.ones((length,), dtype=np.int64)
        for n in score.notes:
            if n.is_rest and float(n.duration) * subdivision >= self.min_num_ticks:
                # the 6-tick beat grid is UNEQUAL (0,1/4,1/3,1/2,2/3,3/4)
                # so int(offset*subdivision) mis-indexes the 2/3 and 3/4
                # positions (int(4.5)=4 would wrongly zero tick 4)
                start = offset_to_tick(n.offset, subdivision)
                end = offset_to_tick(n.end, subdivision)
                out[start:end] = 0
        return out

    def generate(self, length: int) -> np.ndarray:
        return np.ones((length,), dtype=np.int64)


def metadata_tensor(
    score: Score, metadatas, subdivision: int = SUBDIVISION
) -> np.ndarray:
    """Stack metadata channels + trailing voice-id channel into
    ``(length, num_channels)`` (reference folk_dataset.py:144-171; the
    single-voice id channel is all zeros)."""
    length = int(score.highest_time * subdivision)
    channels = [md.evaluate(score, subdivision).reshape(length) for md in metadatas]
    channels.append(np.zeros((length,), dtype=np.int64))  # voice id (1 voice)
    return np.stack(channels, axis=1)
