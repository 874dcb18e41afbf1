"""Per-tick metadata channels synthesized by position
(``inpaintnet_tpu/data/metadata.py``), numpy only.

The AnticipationRNN reads its metadata channels (beat marker, tick in the
beat, and a trailing voice id) through embeddings whose sizes are each
metadata's ``num_values``; the serving engine synthesizes them with
``generate(length)``, as the JAX package's engine does. Only the
position-defined metadatas are here: evaluating a score waits for the
port's data slice.

``BeatMarkerMetadata`` implements the intended semantics (downbeat on tick
0 of each measure, beat on every other beat, slur elsewhere), with the
symbol dictionary in sorted order, exactly as the JAX package does.
"""
from __future__ import annotations

import numpy as np

SUBDIVISION = 6  # ticks per beat (the JAX package's tokenizer constant)
SLUR_SYMBOL = "__"
PAD_SYMBOL = "XX"
BEAT_SYMBOL = "b"
DOWNBEAT_SYMBOL = "B"


class TickMetadata:
    """Position-within-beat counter, values 0..subdivision-1."""

    def __init__(self, subdivision: int = SUBDIVISION):
        self.num_values = subdivision
        self.name = "tick"

    def generate(self, length: int) -> np.ndarray:
        return np.arange(length, dtype=np.int64) % self.num_values


class BeatMarkerMetadata:
    """Beat / downbeat markers over a 4-symbol dictionary, in 4/4."""

    def __init__(self, subdivision: int = SUBDIVISION):
        self.num_values = subdivision
        self.name = "beatmarker"
        self.subdivision = subdivision
        symbols = sorted([PAD_SYMBOL, SLUR_SYMBOL, BEAT_SYMBOL, DOWNBEAT_SYMBOL])
        self.beat_index2symbol_dicts = dict(enumerate(symbols))
        self.beat_symbol2index_dicts = {s: i for i, s in enumerate(symbols)}

    def generate(self, length: int, beats_per_measure: int = 4) -> np.ndarray:
        s2i = self.beat_symbol2index_dicts
        freq = beats_per_measure * self.subdivision
        t = np.full((length,), s2i[SLUR_SYMBOL], dtype=np.int64)
        t[0::freq] = s2i[DOWNBEAT_SYMBOL]
        for beat in range(1, beats_per_measure):
            t[beat * self.subdivision :: freq] = s2i[BEAT_SYMBOL]
        return t
