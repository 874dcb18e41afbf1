"""Score <-> token-tensor codecs on the 6-per-beat unequal tick grid.

The port's copy of ``inpaintnet_tpu/data/tokenizer.py``, numpy only: the two must
give the same bytes.

Re-implements the observable semantics of the reference tokenizer
(``folk_dataset.py:81-142`` ``get_score_tensor``, ``:472-502``
``tensor_to_score``, ``:373-429`` vocab build) as pure numpy over the
:class:`Score` IR:

- tick grid per beat: 0, 1/4, 1/3, 1/2, 2/3, 3/4 (folk_data_helpers.py:22-29)
- tick durations:    1/4, 1/12, 1/6, 1/6, 1/12, 1/4 (folk_dataset.py:72-79)
- a note contributes its index at its articulation tick and ``SLUR_SYMBOL``
  ('__') at continuation ticks
- pitches outside [55, 84] map to ``OOR`` (folk_dataset.py:36,100-105)

Vocabulary: the reference iterates a Python ``set`` (folk_dataset.py:393-420)
so its index assignment is run-nondeterministic; here the vocabulary is
SORTED for reproducibility, and reference ``index_dicts.txt`` files can be
loaded verbatim for checkpoint parity (they are ``repr``'d dicts).
"""
from __future__ import annotations

import ast
import json
from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from inpaintnet_tpu_torch.data.score import Note, Pitch, Score

# Special symbols (reference DatasetManager/helpers.py:4-11)
SLUR_SYMBOL = "__"
START_SYMBOL = "START"
END_SYMBOL = "END"
OUT_OF_RANGE = "OOR"
PAD_SYMBOL = "XX"
BEAT_SYMBOL = "b"
DOWNBEAT_SYMBOL = "B"
REST = "rest"

TICK_VALUES: List[Fraction] = [
    Fraction(0),
    Fraction(1, 4),
    Fraction(1, 3),
    Fraction(1, 2),
    Fraction(2, 3),
    Fraction(3, 4),
]
SUBDIVISION = len(TICK_VALUES)  # 6 ticks per beat


def tick_durations(tick_values: Sequence[Fraction] = TICK_VALUES) -> List[Fraction]:
    """Duration of each tick slot (folk_dataset.py:72-79)."""
    diffs = [n - p for n, p in zip(tick_values[1:], tick_values[:-1])]
    return diffs + [Fraction(1) - tick_values[-1]]


TICK_DURATIONS = tick_durations()


def offset_to_tick(offset, subdivision: int = SUBDIVISION) -> int:
    """Beat-fraction offset -> index on the UNEQUAL tick grid.

    ``int(offset * subdivision)`` mis-indexes the 1/3-family positions
    (offset 3/4 is tick 5 but int(4.5) = 4); map the fractional part onto
    TICK_VALUES instead (floor to the grid position at or below it)."""
    off = offset if isinstance(offset, Fraction) else Fraction(offset)
    beat = int(off)
    frac = off - beat
    idx = 0
    for j, tv in enumerate(TICK_VALUES):
        if tv <= frac:
            idx = j
    return beat * subdivision + idx


DEFAULT_PITCH_RANGE = (55, 84)  # folk_dataset.py:36


def standard_name(note: Note, pitch_range: Optional[Tuple[int, int]] = None) -> str:
    """Token string for a note/rest (reference helpers.py:13-35)."""
    if note.is_rest:
        return REST
    if pitch_range is not None:
        lo, hi = pitch_range
        if not (lo <= note.pitch.midi <= hi):
            return OUT_OF_RANGE
    return note.pitch.name


class Vocabulary:
    """Bidirectional token <-> index mapping."""

    def __init__(self, index2note: Dict[int, str]):
        self.index2note = dict(index2note)
        self.note2index = {v: k for k, v in self.index2note.items()}

    def __len__(self):
        return len(self.index2note)

    def __contains__(self, token: str):
        return token in self.note2index

    def index(self, token: str) -> int:
        return self.note2index[token]

    def token(self, index: int) -> str:
        return self.index2note[int(index)]

    @property
    def slur_index(self) -> int:
        return self.note2index[SLUR_SYMBOL]

    @property
    def start_index(self) -> int:
        return self.note2index[START_SYMBOL]

    @property
    def end_index(self) -> int:
        return self.note2index[END_SYMBOL]

    @property
    def rest_index(self) -> int:
        return self.note2index[REST]

    @staticmethod
    def build(token_iter: Iterable[str]) -> "Vocabulary":
        """Build a vocabulary from corpus tokens, sorted for determinism.

        The special symbols SLUR/START/END are always included
        (folk_dataset.py:393-397). 'rest' enters through the corpus like any
        other token.
        """
        tokens = set(token_iter)
        tokens.update([SLUR_SYMBOL, START_SYMBOL, END_SYMBOL])
        ordered = sorted(tokens)
        return Vocabulary({i: t for i, t in enumerate(ordered)})

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"index2note": self.index2note}, f, indent=1, sort_keys=True)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        with open(path) as f:
            data = json.load(f)
        return Vocabulary({int(k): v for k, v in data["index2note"].items()})

    @staticmethod
    def load_reference_dicts(path: str) -> "Vocabulary":
        """Load a reference ``index_dicts.txt`` (two repr'd dict lines,
        folk_dataset.py:373-381) for checkpoint-parity runs."""
        with open(path) as f:
            lines = [line.rstrip("\n") for line in f]
        index2note_list = ast.literal_eval(lines[0])
        d = index2note_list[0] if isinstance(index2note_list, list) else index2note_list
        return Vocabulary({int(k): v for k, v in d.items()})


def score_tokens(score: Score, pitch_range=DEFAULT_PITCH_RANGE) -> List[str]:
    """All token strings a score contributes to the vocabulary."""
    return [standard_name(n, pitch_range) for n in score.notes]


def score_to_tensor(
    score: Score,
    vocab: Vocabulary,
    pitch_range=DEFAULT_PITCH_RANGE,
    subdivision: int = SUBDIVISION,
) -> np.ndarray:
    """Convert a score to its token index sequence, shape ``(length,)`` with
    ``length = highest_time * subdivision``.

    Exact port of the reference walk (folk_dataset.py:114-141): advance a
    pointer over notes against the unequal tick clock; the active note's
    token index is written at its articulation tick, SLUR at continuations.
    """
    if not score.on_ticks(TICK_VALUES):
        raise ValueError(f"score {score.title!r} has notes off the tick grid")
    notes = score.notes
    length = int(score.highest_time * subdivision)
    out = np.empty((length,), dtype=np.int32)
    slur = vocab.slur_index

    j = 0
    num_notes = len(notes)
    current_tick = Fraction(0)
    is_articulated = True
    i = 0
    while i < length:
        if j < num_notes - 1 and notes[j + 1].offset <= current_tick:
            j += 1
            is_articulated = True
            continue
        if is_articulated:
            tok = standard_name(notes[j], pitch_range)
            out[i] = _lookup_token(vocab, tok, notes[j])
        else:
            out[i] = slur
        i += 1
        current_tick += TICK_DURATIONS[(i - 1) % subdivision]
        is_articulated = False
    return out


def _lookup_token(vocab: Vocabulary, tok: str, note: Note) -> int:
    """Vocab lookup with enharmonic fallback.

    The reference GROWS its dictionaries when an unseen spelling appears
    (folk_dataset.py:102-112) — which breaks trained embeddings. Here an
    in-range pitch whose spelling is missing falls back to any enharmonic
    spelling of the same MIDI number already in the vocabulary, then to OOR.
    """
    if tok in vocab:
        return vocab.index(tok)
    if note.is_note:
        for cand in _enharmonic_spellings(note.pitch):
            if cand in vocab:
                return vocab.index(cand)
    if OUT_OF_RANGE in vocab:
        return vocab.index(OUT_OF_RANGE)
    raise KeyError(f"token {tok!r} not in vocabulary and no fallback available")


def _enharmonic_spellings(pitch: Pitch) -> List[str]:
    """All spellings of a MIDI pitch with |alter| <= 2, nearest-first."""
    from inpaintnet_tpu_torch.data.score import _STEP_PC, _STEPS

    midi = pitch.midi
    out = []
    for step in _STEPS:
        for octave in (pitch.octave - 1, pitch.octave, pitch.octave + 1):
            alter = midi - (12 * (octave + 1) + _STEP_PC[step])
            if -2 <= alter <= 2:
                out.append(Pitch(step, alter, octave).name)
    out.sort(key=lambda name: abs(Pitch.from_name(name).alter))
    return out


def tensor_to_score(
    tensor: np.ndarray,
    vocab: Vocabulary,
    subdivision: int = SUBDIVISION,
    time_signature: Tuple[int, int] = (4, 4),
) -> Score:
    """Inverse codec (folk_dataset.py:472-502): a token opens a note/rest and
    each following SLUR tick extends it by that tick slot's duration.
    START/END/PAD/OOR decode to rests (helpers.py:38-56)."""
    flat = np.asarray(tensor).reshape(-1)
    slur = vocab.slur_index
    notes: List[Note] = []
    offset = Fraction(0)
    cur_start: Optional[Fraction] = None
    cur_token: Optional[str] = None
    for tick_index, idx in enumerate(flat):
        dur = TICK_DURATIONS[tick_index % subdivision]
        if int(idx) != slur:
            if cur_token is not None:
                notes.append(_token_to_note(cur_token, cur_start, offset - cur_start))
            cur_start = offset
            cur_token = vocab.token(int(idx))
        offset += dur
    if cur_token is not None:
        notes.append(_token_to_note(cur_token, cur_start, offset - cur_start))
    return Score(notes=notes, time_signature=time_signature)


def _token_to_note(token: str, offset: Fraction, duration: Fraction) -> Note:
    if token in (REST, START_SYMBOL, END_SYMBOL, PAD_SYMBOL, OUT_OF_RANGE, SLUR_SYMBOL):
        return Note(offset, duration, None)
    return Note(offset, duration, Pitch.from_name(token))


def extract_with_padding(
    tensor: np.ndarray,
    start_tick: int,
    end_tick: int,
    start_index: int,
    end_index: int,
) -> np.ndarray:
    """Slice ``tensor[start_tick:end_tick]`` padding out-of-range positions
    with START / END indices (folk_dataset.py:302-338)."""
    assert start_tick < end_tick
    length = tensor.shape[-1]
    parts = []
    if start_tick < 0:
        parts.append(np.full((-start_tick,), start_index, dtype=tensor.dtype))
    lo, hi = max(start_tick, 0), min(end_tick, length)
    parts.append(tensor[..., lo:hi])
    if end_tick > length:
        parts.append(np.full((end_tick - length,), end_index, dtype=tensor.dtype))
    return np.concatenate(parts, axis=-1)


def extract_metadata_with_padding(
    metadata: np.ndarray, start_tick: int, end_tick: int
) -> np.ndarray:
    """Same window logic for the (length, num_metadata) tensor; padding is
    zeros (folk_dataset.py:340-371)."""
    assert start_tick < end_tick
    length, num_md = metadata.shape
    parts = []
    if start_tick < 0:
        parts.append(np.zeros((-start_tick, num_md), dtype=metadata.dtype))
    lo, hi = max(start_tick, 0), min(end_tick, length)
    parts.append(metadata[lo:hi])
    if end_tick > length:
        parts.append(np.zeros((end_tick - length, num_md), dtype=metadata.dtype))
    return np.concatenate(parts, axis=0)


def all_transposition_semitones(
    score: Score, pitch_range=DEFAULT_PITCH_RANGE
) -> List[int]:
    """Every semitone shift keeping the score within the corpus pitch range
    (folk_dataset.py:504-523)."""
    min_p, max_p = score.pitch_range()
    lo, hi = pitch_range
    return list(range(lo - min_p, hi - max_p + 1))
