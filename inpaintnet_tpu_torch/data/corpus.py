"""Folk corpus ingestion: The Session dump -> validated Score iterators.

The port's copy of ``inpaintnet_tpu/data/corpus.py``, numpy only: the two must
give the same bytes.

Counterpart of ``FolkIteratorGenerator``
(folk_data_helpers.py:124-560). Differences by design:

- parsing uses the framework's own ABC parser (no music21);
- the corpus dump location is an explicit argument (no network download —
  the reference shells out to wget, folk_data_helpers.py:204-210);
- the valid-file list is cached to ``<repr>valid_filepaths.txt`` with the
  same naming scheme so reference-shipped lists can be reused;
- all randomness is seeded.

Validity rules replicated from folk_data_helpers.py:248-349: title present,
single voice, no chord symbols, a single allowed time signature, notes
present, at most ``MAX_NOTES`` notes, no 32nd/64th notes, repeats expand,
and every note offset on the 6-per-beat tick grid.
"""
from __future__ import annotations

import os
from fractions import Fraction
from typing import Iterator, List, Optional, Sequence, Tuple

from inpaintnet_tpu_torch.data.abc_parser import AbcParseError, parse_abc
from inpaintnet_tpu_torch.data.score import Score
from inpaintnet_tpu_torch.data.tokenizer import TICK_VALUES

MAX_NOTES = 140  # folk_data_helpers.py:31

# Bump when validity-filter or parser semantics change: self-generated
# valid-file lists carry this in a sidecar .meta file and are rebuilt on
# mismatch. Lists WITHOUT a sidecar are trusted only if they are one of
# the reference's SHIPPED lists (verified by content hash — they are the
# ground truth the filter approximates); anything else sidecar-less is a
# stale pre-versioning cache and is rebuilt.
FILTER_VERSION = 2  # v2: multi-time-signature drop + opening-signature parse

# sha256 of the reference repo's shipped valid-file lists
_REFERENCE_LIST_HASHES = {
    "2bf86760bb1b0e2ef223777cce2c270d95475c06458b3ce0b6b18fa532295c61",
    "721059be5a4377e2f321eb2c2f2047e5673a0c97acb63b97991c24139ca9b3ad",
    "d2f928a8879b37b6d2205cb15538980a762549c02561479187e5786260d7e793",
}


def _is_reference_shipped_list(path: str) -> bool:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest() in _REFERENCE_LIST_HASHES


def split_raw_dump(dump_path: str, out_dir: str) -> int:
    """Split a sessions_data_clean.txt-style dump (blank-line separated)
    into per-tune ``tune_<i>.abc`` files (folk_data_helpers.py:212-228).
    Returns the number of tunes written."""
    os.makedirs(out_dir, exist_ok=True)
    index = 0
    buf: List[str] = []

    def flush():
        nonlocal index, buf
        with open(os.path.join(out_dir, f"tune_{index}.abc"), "w") as f:
            f.writelines(buf)
        index += 1
        buf = []

    with open(dump_path) as f:
        for line in f:
            if line == "\n":
                flush()
            else:
                buf.append(line)
    flush()
    return index


def _tune_has_title(text: str) -> bool:
    return any(line.startswith("T:") for line in text.splitlines())


def _tune_is_multivoice(text: str) -> bool:
    # folk_data_helpers.py:544-560
    for line in text.splitlines():
        if line.replace(" ", "").startswith("V:2"):
            return True
    return False


def _tune_contains_chords(text: str) -> bool:
    return '"' in text  # folk_data_helpers.py:532-542


def _tune_has_multiple_time_sigs(text: str) -> bool:
    """The reference drops tunes with more than one music21 TimeSignature
    object — i.e. any mid-tune M: change, even to the same value
    (folk_data_helpers.py:287-289)."""
    count = 0
    in_body = False
    for line in text.splitlines():
        line = line.split("%", 1)[0]
        if line.startswith("K:"):
            in_body = True
        if line.startswith("M:"):
            count += 1
        elif in_body:
            count += line.count("[M:")
    return count > 1


def _has_forbidden_durations(score: Score) -> bool:
    """Reject 32nd/64th notes (folk_data_helpers.py:308-319). On our IR this
    is a direct duration check: < 1/8 quarterLength."""
    return any(n.is_note and n.duration < Fraction(1, 8) for n in score.notes)


class FolkCorpus:
    """Iterator over validated folk tunes as Score objects."""

    def __init__(
        self,
        raw_dir: str,
        num_elements: Optional[int] = None,
        time_sigs: Sequence[Tuple[int, int]] = ((4, 4),),
        cache_dir: Optional[str] = None,
    ):
        self.raw_dir = raw_dir
        self.num_elements = num_elements if num_elements is not None else 25000
        self.time_sigs = [tuple(ts) for ts in time_sigs]
        self.cache_dir = cache_dir or raw_dir
        self.valid_files_list = os.path.join(
            self.cache_dir, repr(self) + "valid_filepaths.txt"
        )
        self._valid_tune_filenames: Optional[List[str]] = None

    def __repr__(self):
        # Mirrors FolkIteratorGenerator.__repr__ (folk_data_helpers.py:189-202)
        ts = str([tuple(t) for t in self.time_sigs]).replace(" ", "")
        return f"FolkItGen({ts})"

    # ------------------------------------------------------------------ #
    @property
    def valid_tune_filenames(self) -> List[str]:
        if self._valid_tune_filenames is None:
            self._valid_tune_filenames = self._get_valid_tune_filenames()
        return self._valid_tune_filenames

    def _get_valid_tune_filenames(self) -> List[str]:
        meta_path = self.valid_files_list + ".meta"
        if os.path.exists(self.valid_files_list):
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    stale = f.read().strip() != f"filter_version={FILTER_VERSION}"
            else:
                # no sidecar: either a reference-shipped ground-truth list
                # (trust) or a pre-versioning self-generated cache (rebuild)
                stale = not _is_reference_shipped_list(self.valid_files_list)
            if not stale:
                with open(self.valid_files_list) as f:
                    return [line.rstrip("\n") for line in f]
            print(
                f"valid-file list {self.valid_files_list} was built by an "
                "older validity filter; re-scanning the corpus"
            )
        if not os.path.isdir(self.raw_dir):
            raise FileNotFoundError(
                f"corpus directory {self.raw_dir!r} does not exist — point "
                "--corpus_dir / $INPAINTNET_CORPUS_DIR at a directory of "
                "tune_<i>.abc files (split a Session dump with "
                "inpaintnet_tpu_torch.data.corpus.split_raw_dump, or create a "
                "synthetic corpus with inpaintnet_tpu_torch.data.synthetic."
                "generate_corpus)"
            )
        names = sorted(
            (
                fn
                for fn in os.listdir(self.raw_dir)
                if fn.startswith("tune") and fn.endswith(".abc")
            ),
            key=lambda s: (len(s), s),
        )
        valid = [fn for fn in names if self.is_valid(os.path.join(self.raw_dir, fn))]
        os.makedirs(os.path.dirname(self.valid_files_list) or ".", exist_ok=True)
        with open(self.valid_files_list, "w") as f:
            for fn in valid:
                f.write(fn + "\n")
        with open(meta_path, "w") as f:
            f.write(f"filter_version={FILTER_VERSION}\n")
        return valid

    def is_valid(self, path: str) -> bool:
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            return False
        if not _tune_has_title(text):
            return False
        if _tune_is_multivoice(text) or _tune_contains_chords(text):
            return False
        if _tune_has_multiple_time_sigs(text):
            return False
        try:
            # ONE tokenization pass yields both views (the expanded score
            # must match get_score_from_path(fix_and_expand=True) exactly)
            score, expanded = parse_abc(text, return_both=True)
            if tuple(score.time_signature) not in self.time_sigs:
                return False
            if not score.pitches_midi():
                return False
            if len(score.notes) > MAX_NOTES:
                return False
            if _has_forbidden_durations(score):
                return False
            expanded = expanded.fix_pick_up_measure().fix_last_measure()
            if not expanded.on_ticks(TICK_VALUES):
                return False
        except (AbcParseError, ValueError, ZeroDivisionError, KeyError, IndexError):
            return False
        return True

    def get_score_from_path(self, path: str, fix_and_expand: bool = False) -> Score:
        """(folk_data_helpers.py:351-364)"""
        with open(path) as f:
            score = parse_abc(f.read(), expand_repeats=fix_and_expand)
        if fix_and_expand:
            score = score.fix_pick_up_measure().fix_last_measure()
        return score

    def __call__(self) -> Iterator[Score]:
        return self.score_generator()

    def scan_dataset(self) -> dict:
        """Corpus statistics sweep (reference scan_dataset,
        folk_data_helpers.py:366-461): counts, pitch range/distribution,
        duration histogram, time-signature breakdown."""
        import numpy as np
        from fractions import Fraction

        pitch_dist = np.zeros(128, dtype=np.int64)
        dur_bins = {  # quarterLength -> label
            Fraction(1): "quarter", Fraction(1, 2): "eighth",
            Fraction(2): "half", Fraction(1, 4): "16th",
            Fraction(4): "whole",
        }
        dur_dist = {v: 0 for v in dur_bins.values()}
        dur_dist["other"] = 0
        ts_counts: dict = {}
        num_notes = []
        min_pitch, max_pitch = 127, 0
        for score in self.score_generator():
            ps = score.pitches_midi()
            if not ps:
                continue
            num_notes.append(len(score.notes))
            min_pitch = min(min_pitch, min(ps))
            max_pitch = max(max_pitch, max(ps))
            for p in ps:
                pitch_dist[p] += 1
            for n in score.notes:
                if n.is_note:
                    dur_dist[dur_bins.get(n.duration, "other")] = (
                        dur_dist.get(dur_bins.get(n.duration, "other"), 0) + 1
                    )
            ts = tuple(score.time_signature)
            ts_counts[ts] = ts_counts.get(ts, 0) + 1
        return {
            "num_files": len(num_notes),
            "num_notes": num_notes,
            "pitch_dist": pitch_dist,
            "min_pitch": min_pitch,
            "max_pitch": max_pitch,
            "dur_dist": dur_dist,
            "time_signatures": ts_counts,
        }

    def score_generator(self) -> Iterator[Score]:
        for i, fn in enumerate(self.valid_tune_filenames):
            if i >= self.num_elements:
                break
            try:
                yield self.get_score_from_path(
                    os.path.join(self.raw_dir, fn), fix_and_expand=True
                )
            except (AbcParseError, ValueError, ZeroDivisionError) as e:  # pragma: no cover
                print(f"{fn} is not parsable: {e}")
