"""Datasets: corpus -> cached tensor stores -> batch iterators.

The port's copy of ``inpaintnet_tpu/data/dataset.py``, numpy only: the two must
give the same bytes.

Counterpart of ``DatasetManager/music_dataset.py`` and
``the_session/folk_dataset.py``. Key re-designs:

- the tensor store is a versioned **npz** file of plain numpy arrays (no
  pickled torch objects — reference pickles whole ``TensorDataset``s,
  music_dataset.py:126-162), built AOT by the offline tokenizer; training
  touches only arrays;
- the train/test file split of ``FolkDatasetNBars`` is **seeded and
  persisted** (the reference shuffles with unseeded ``random.shuffle``,
  folk_dataset.py:782 — reproducible only via its pickle cache);
- ``data_loaders`` returns lightweight numpy batch iterators (seeded
  shuffle, drop-last) instead of torch ``DataLoader``s; the trainer moves
  each batch to its device.

Class/API names mirror the reference so downstream code ports directly.
"""
from __future__ import annotations

import hashlib
import json
import os
from abc import ABC, abstractmethod
from typing import List, Optional, Sequence, Tuple

import numpy as np

from inpaintnet_tpu_torch.data.corpus import FolkCorpus
from inpaintnet_tpu_torch.data.exceptions import LeadsheetParsingException
from inpaintnet_tpu_torch.data.metadata import Metadata, metadata_tensor
from inpaintnet_tpu_torch.data.score import Score
from inpaintnet_tpu_torch.data.tokenizer import (
    DEFAULT_PITCH_RANGE,
    REST,
    SUBDIVISION,
    TICK_VALUES,
    Vocabulary,
    all_transposition_semitones,
    extract_metadata_with_padding,
    extract_with_padding,
    score_to_tensor,
    score_tokens,
    tensor_to_score,
)


class BatchIterator:
    """Iterates (score_batch, metadata_batch) numpy views.

    Train iterators reshuffle each pass with a per-epoch seed; eval
    iterators are in-order. ``drop_last`` matches the reference loaders
    (music_dataset.py:195-220).
    """

    def __init__(self, arrays, batch_size, shuffle=False, drop_last=True, seed=0):
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_examples = arrays[0].shape[0]

    def __len__(self):
        if self.drop_last:
            return self.num_examples // self.batch_size
        return -(-self.num_examples // self.batch_size)

    def __iter__(self):
        idx = np.arange(self.num_examples)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
            self.epoch += 1
        nb = len(self)
        for b in range(nb):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield tuple(a[sel] for a in self.arrays)


class PrefetchIterator:
    """Background-thread prefetch over a BatchIterator (the
    equivalent of the reference's 4 DataLoader workers,
    music_dataset.py:195-202): host batch prep overlaps device compute."""

    def __init__(self, inner: "BatchIterator", depth: int = 2):
        self.inner = inner
        self.depth = depth
        self.batch_size = inner.batch_size

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error: list = []

        def worker():
            # the sentinel must reach the queue even when the inner
            # iterator raises — otherwise the consumer's q.get() blocks
            # forever and training hangs instead of surfacing the error
            try:
                for item in self.inner:
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error:
            raise error[0]


class MusicDataset(ABC):
    """Abstract dataset: score<->tensor contract + cached tensor store +
    loader construction (reference music_dataset.py:7-221)."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or os.path.join(os.getcwd(), "dataset_cache")
        os.makedirs(self.cache_dir, exist_ok=True)
        self._arrays: Optional[Tuple[np.ndarray, ...]] = None

    # --- abstract score<->tensor API ------------------------------------ #
    @abstractmethod
    def make_arrays(self) -> Tuple[np.ndarray, ...]:
        """Build the full (score, metadata) arrays from the corpus."""

    @abstractmethod
    def get_score_tensor(self, score: Score) -> np.ndarray:
        ...

    @abstractmethod
    def get_metadata_tensor(self, score: Score) -> np.ndarray:
        ...

    @abstractmethod
    def tensor_to_score(self, tensor_score) -> Score:
        ...

    # --- cache ----------------------------------------------------------- #
    def _store_key_extra(self) -> str:
        """Cache-identity material BEYOND ``repr`` (which also names
        checkpoints and must stay reference-shaped). Subclasses append
        anything that changes the built arrays without changing the model
        config — e.g. the split seed (a seed-1 'test' build must NOT load
        the seed-0 store: that would silently evaluate on seed-0 train
        files) and the corpus location."""
        return ""

    @property
    def store_path(self) -> str:
        key = repr(self) + self._store_key_extra()
        digest = hashlib.sha1(key.encode()).hexdigest()[:12]
        return os.path.join(self.cache_dir, f"{type(self).__name__}_{digest}.npz")

    @property
    def arrays(self) -> Tuple[np.ndarray, ...]:
        if self._arrays is None:
            if os.path.exists(self.store_path):
                with np.load(self.store_path) as z:
                    self._arrays = tuple(z[k] for k in sorted(z.files))
            else:
                self._arrays = self.make_arrays()
                np.savez_compressed(
                    self.store_path,
                    **{f"arr{i}": a for i, a in enumerate(self._arrays)},
                )
        return self._arrays

    # --- reference-API aliases -------------------------------------------- #
    def make_tensor_dataset(self):
        """Reference-API alias (music_dataset.py:26-31)."""
        return self.make_arrays()

    @property
    def tensor_dataset(self):
        """Reference-API alias for the cached arrays
        (music_dataset.py:125-142)."""
        return self.arrays

    def data_loaders(self, batch_size: int, split=(0.85, 0.10), seed: int = 0):
        """Split the example axis into train/val/test and wrap in iterators
        (contiguous split like the reference, music_dataset.py:185-194)."""
        assert sum(split) < 1
        arrays = self.arrays
        n = arrays[0].shape[0]
        a, b = split
        i1, i2 = int(a * n), int((a + b) * n)
        train = tuple(x[:i1] for x in arrays)
        val = tuple(x[i1:i2] for x in arrays)
        test = tuple(x[i2:] for x in arrays)
        # val/test keep the tail batch (the reference drops it,
        # music_dataset.py:204-220 — dropping eval data is a bug class we
        # choose not to replicate); train batches are prefetched on a
        # background thread (the reference used 4 DataLoader workers)
        return (
            PrefetchIterator(BatchIterator(train, batch_size, shuffle=True, seed=seed)),
            BatchIterator(val, batch_size, shuffle=False, drop_last=False),
            BatchIterator(test, batch_size, shuffle=False, drop_last=False),
        )


class FolkDataset(MusicDataset):
    """Sliding-window tick sequences over the folk corpus
    (reference folk_dataset.py:13-523)."""

    def __init__(
        self,
        name: str,
        corpus_it_gen: Optional[FolkCorpus] = None,
        metadatas: Optional[Sequence[Metadata]] = None,
        sequences_size: int = 32,
        cache_dir: Optional[str] = None,
    ):
        super().__init__(cache_dir=cache_dir)
        self.name = name
        self.corpus_it_gen = corpus_it_gen
        self.num_melodies = corpus_it_gen.num_elements if corpus_it_gen else 0
        self.num_voices = 1
        self.NOTES = 0
        self.pitch_range = list(DEFAULT_PITCH_RANGE)
        self.tick_values = TICK_VALUES
        self.subdivision = SUBDIVISION
        self.seq_size_in_beats = sequences_size
        self.metadatas = list(metadatas) if metadatas else []
        self._vocab: Optional[Vocabulary] = None
        self.dicts_dir = os.path.join(self.cache_dir, "dicts")
        os.makedirs(self.dicts_dir, exist_ok=True)

    def _store_key_extra(self) -> str:
        # the corpus location changes the built arrays but not the
        # model-facing repr
        gen = self.corpus_it_gen
        return f"|{getattr(gen, 'raw_dir', '')}" if gen else ""

    def __repr__(self):
        return (
            f"FolkDataset({self.name},"
            f"{[m.name for m in self.metadatas]},"
            f"{self.seq_size_in_beats},"
            f"{self.subdivision})"
            f"{self.num_melodies}"
        )

    def iterator_gen(self):
        return (score for score in self.corpus_it_gen())

    # --- vocabulary ------------------------------------------------------ #
    @property
    def vocab_path(self) -> str:
        return os.path.join(self.dicts_dir, "vocab.json")

    @property
    def vocab(self) -> Vocabulary:
        if self._vocab is None:
            if os.path.exists(self.vocab_path):
                self._vocab = Vocabulary.load(self.vocab_path)
            else:
                self._vocab = self.compute_vocabulary()
                self._vocab.save(self.vocab_path)
        return self._vocab

    @vocab.setter
    def vocab(self, value: Vocabulary):
        self._vocab = value

    def compute_vocabulary(self) -> Vocabulary:
        """Corpus scan incl. all in-range transpositions, so transposed
        datasets never hit unknown tokens (the reference instead grows the
        dict on the fly with a warning, folk_dataset.py:102-112)."""
        tokens: List[str] = [REST]
        for i, score in enumerate(self.iterator_gen()):
            if i > self.num_melodies:
                break
            if not self.is_in_range(score):
                tokens.extend(score_tokens(score, tuple(self.pitch_range)))
                continue
            for semi in all_transposition_semitones(score, tuple(self.pitch_range)):
                tokens.extend(
                    score_tokens(score.transpose(semi), tuple(self.pitch_range))
                )
        return Vocabulary.build(tokens)

    # legacy-compatible accessors (used throughout reference model code)
    @property
    def note2index_dicts(self):
        return [self.vocab.note2index]

    @property
    def index2note_dicts(self):
        return [self.vocab.index2note]

    # --- conversions ------------------------------------------------------ #
    def get_score_tensor(self, score: Score) -> np.ndarray:
        t = score_to_tensor(score, self.vocab, tuple(self.pitch_range))
        return t[None, :]  # (1, length) like the reference

    def get_metadata_tensor(self, score: Score) -> np.ndarray:
        return metadata_tensor(score, self.metadatas, self.subdivision)

    def transposed_score_and_metadata_tensors(self, score: Score, semi_tone: int):
        ts = score.transpose(semi_tone)
        return self.get_score_tensor(ts), self.get_metadata_tensor(ts)

    def tensor_to_score(self, tensor_score) -> Score:
        return tensor_to_score(np.asarray(tensor_score), self.vocab, self.subdivision)

    def is_in_range(self, score: Score) -> bool:
        ps = score.pitches_midi()
        if not ps:
            return False
        return min(ps) >= self.pitch_range[0] and max(ps) <= self.pitch_range[1]

    def empty_score_tensor(self, score_length: int) -> np.ndarray:
        return np.full((1, score_length), self.vocab.start_index, dtype=np.int32)

    def random_score_tensor(self, score_length: int, seed: int = 0) -> np.ndarray:
        rng = np.random.RandomState(seed)
        return rng.randint(len(self.vocab), size=(1, score_length)).astype(np.int32)

    def all_transposition_intervals(self, score: Score) -> List[int]:
        return all_transposition_semitones(score, tuple(self.pitch_range))

    # --- dataset assembly -------------------------------------------------- #
    def make_arrays(self):
        """Sliding windows with START/END padding over every (untransposed)
        score (reference FolkDataset.make_tensor_dataset,
        folk_dataset.py:208-263): window = seq_size_in_beats beats, stride
        1 beat, starting at -(seq-1) beats."""
        leads, mds = [], []
        count = 0
        for score in self.iterator_gen():
            if not self.is_in_range(score):
                continue
            if count > self.num_melodies:
                break
            count += 1
            try:
                lead = self.get_score_tensor(score)[0]
                md = self.get_metadata_tensor(score)
            except (LeadsheetParsingException, KeyError, ValueError) as e:
                print(e)
                continue
            total_beats = int(score.highest_time)
            for off in range(-self.seq_size_in_beats + 1, total_beats):
                s = off * self.subdivision
                e = (off + self.seq_size_in_beats) * self.subdivision
                leads.append(
                    extract_with_padding(
                        lead, s, e, self.vocab.start_index, self.vocab.end_index
                    )
                )
                mds.append(extract_metadata_with_padding(md, s, e))
        score_arr = np.stack(leads).astype(np.int32)[:, None, :]
        md_arr = np.stack(mds).astype(np.int32)[:, None, :, :]
        return score_arr, md_arr


class FolkMeasuresDataset(FolkDataset):
    """Per-measure examples (24 ticks of 4/4) — reference
    folk_dataset.py:526-708."""

    def __repr__(self):
        return (
            f"FolkMeasuresDataset({self.name},"
            f"{[m.name for m in self.metadatas]},"
            f"{self.subdivision})"
            f"{self.num_melodies}"
        )

    @property
    def measure_seq_len(self) -> int:
        return self.subdivision * 4

    def split_score_tensor_to_measures(self, tensor_score: np.ndarray) -> np.ndarray:
        _, seq_len = tensor_score.shape
        msl = self.measure_seq_len
        num_measures = seq_len // msl
        return tensor_score[0, : num_measures * msl].reshape(num_measures, msl)

    def split_metadata_tensor_to_measures(self, md: np.ndarray) -> np.ndarray:
        seq_len, num_md = md.shape
        msl = self.measure_seq_len
        num_measures = seq_len // msl
        return md[: num_measures * msl].reshape(num_measures, msl, num_md)

    def make_arrays(self):
        measures, mds = [], []
        for score in self.iterator_gen():
            if not self.is_in_range(score):
                continue
            measures.append(
                self.split_score_tensor_to_measures(self.get_score_tensor(score))
            )
            mds.append(
                self.split_metadata_tensor_to_measures(self.get_metadata_tensor(score))
            )
        return (
            np.concatenate(measures).astype(np.int32),
            np.concatenate(mds).astype(np.int32),
        )

    # --- musical attribute probes (folk_dataset.py:607-708) -------------- #
    def get_num_notes_in_measure(self, measure_tensor: np.ndarray) -> np.ndarray:
        msl = measure_tensor.shape[-1]
        slur = self.vocab.slur_index
        rest = self.vocab.rest_index
        slur_count = (measure_tensor == slur).sum(-1)
        rest_count = (measure_tensor == rest).sum(-1)
        return (msl - slur_count - rest_count).astype(np.float32) / float(msl)

    def get_note_range_of_measure(self, measure_tensor: np.ndarray) -> np.ndarray:
        lo, hi = self.pitch_range
        midis = self._token_midi_lut()
        m = midis[measure_tensor]  # -1 where not a pitch
        has = m >= 0
        high = np.where(has, m, -(10**6)).max(-1)
        low = np.where(has, m, 10**6).min(-1)
        rng = np.where(has.any(-1), high - low, 0)
        return rng.astype(np.float32) / float(hi - lo)

    def get_rhythmic_entropy(self, measure_tensor: np.ndarray) -> np.ndarray:
        from scipy import stats

        slur = self.vocab.slur_index
        onsets = (measure_tensor != slur).astype(np.float64)
        return stats.entropy(onsets.T)

    def get_beat_strength(self, measure_tensor: np.ndarray) -> np.ndarray:
        slur = self.vocab.slur_index
        onsets = (measure_tensor != slur).astype(np.float64)
        weights = np.tile(np.array([1, 0.008, 0.008, 0.15, 0.008, 0.008]), 4)
        return (onsets * weights).sum(-1)

    def _token_midi_lut(self) -> np.ndarray:
        """token index -> midi pitch, -1 for non-pitch tokens."""
        from inpaintnet_tpu_torch.data.score import Pitch

        lut = np.full((len(self.vocab),), -1, dtype=np.int32)
        for i, tok in self.vocab.index2note.items():
            try:
                lut[i] = Pitch.from_name(tok).midi
            except (ValueError, KeyError, IndexError):
                pass
        return lut


class FolkMeasuresDatasetTranspose(FolkMeasuresDataset):
    """Measure dataset augmented with every in-range transposition
    (folk_dataset.py:711-748)."""

    def __repr__(self):
        return (
            f"FolkMeasuresDatasetTranspose({self.name},"
            f"{[m.name for m in self.metadatas]},"
            f"{self.subdivision})"
            f"{self.num_melodies}"
        )

    def make_arrays(self):
        measures, mds = [], []
        for score in self.iterator_gen():
            if not self.is_in_range(score):
                continue
            for semi in self.all_transposition_intervals(score):
                st, mt = self.transposed_score_and_metadata_tensors(score, semi)
                measures.append(self.split_score_tensor_to_measures(st))
                mds.append(self.split_metadata_tensor_to_measures(mt))
        return (
            np.concatenate(measures).astype(np.int32),
            np.concatenate(mds).astype(np.int32),
        )


class FolkDatasetNBars(FolkMeasuresDataset):
    """The training workhorse: transposition-augmented n-bar windows
    (default 16 bars = 384 ticks) with a seeded, persisted file-level
    train/test split (fixes reference folk_dataset.py:782's unseeded
    shuffle)."""

    def __init__(
        self,
        name: str,
        corpus_it_gen: Optional[FolkCorpus] = None,
        metadatas: Optional[Sequence[Metadata]] = None,
        sequences_size: int = 32,
        cache_dir: Optional[str] = None,
        num_bars: int = 16,
        train: bool = True,
        split_seed: int = 0,
    ):
        super().__init__(
            name=name,
            corpus_it_gen=corpus_it_gen,
            metadatas=metadatas,
            sequences_size=sequences_size,
            cache_dir=cache_dir,
        )
        self.train = train
        self.n_bars = num_bars
        self.num_beats_per_bar = 4
        self.seq_size_in_beats = self.num_beats_per_bar * self.n_bars
        self.split_seed = split_seed
        self.dataset_type = "train" if train else "test"
        self.dataset_filenames = self._split_filenames()
        self.num_dataset_files = len(self.dataset_filenames)

    def __repr__(self):
        return (
            f"FolkDatasetNBars({self.n_bars}"
            f"{[m.name for m in self.metadatas]})"
            f"{self.num_melodies}_{self.dataset_type}"
        )

    def _store_key_extra(self) -> str:
        # the split seed changes which files land in train/test
        return super()._store_key_extra() + f"|seed{self.split_seed}"

    @property
    def split_manifest_path(self) -> str:
        return os.path.join(
            self.cache_dir,
            f"split_{repr(self.corpus_it_gen)}_{self.num_melodies}_seed{self.split_seed}.json",
        )

    def _split_filenames(self) -> List[str]:
        """90/10 file-level split, persisted as a JSON manifest so train and
        test datasets (and later runs) agree."""
        if os.path.exists(self.split_manifest_path):
            with open(self.split_manifest_path) as f:
                manifest = json.load(f)
        else:
            names = list(self.corpus_it_gen.valid_tune_filenames)
            rng = np.random.RandomState(self.split_seed)
            rng.shuffle(names)
            names = names[: self.corpus_it_gen.num_elements]
            cut = int(0.9 * len(names))
            manifest = {"train": names[:cut], "test": names[cut:]}
            with open(self.split_manifest_path, "w") as f:
                json.dump(manifest, f)
        return manifest[self.dataset_type]

    def make_arrays(self):
        leads, mds = [], []
        native = self._native_tokenizer()
        for fn in self.dataset_filenames:
            self._append_tune(fn, leads, mds, native=native)
        score_arr = np.stack(leads).astype(np.int32)[:, None, :]
        md_arr = np.stack(mds).astype(np.int32)[:, None, :, :]
        return score_arr, md_arr

    def _native_tokenizer(self):
        """The C++ AOT tokenizer (native/abctok.cpp), if built. Encoding
        equivalence with the Python path is test-enforced
        (tests/test_native_tokenizer.py)."""
        try:
            from inpaintnet_tpu_torch.data.native import NativeTokenizer

            if NativeTokenizer.available():
                v = self.vocab
                return NativeTokenizer(
                    [v.token(i) for i in range(len(v))], tuple(self.pitch_range)
                )
        except (RuntimeError, OSError):
            pass
        return None

    def _append_tune(self, fn: str, leads: list, mds: list, native=None):
        """(reference get_tensor_dataset, folk_dataset.py:802-838): windows
        of ``seq_size_in_beats`` starting at -1 bar, striding a full window.

        Metadata channels are pitch-invariant, so they are computed once per
        tune and shared across transpositions (the reference recomputes
        identical tensors per transposition)."""
        path = os.path.join(self.corpus_it_gen.raw_dir, fn)
        try:
            score = self.corpus_it_gen.get_score_from_path(path, fix_and_expand=True)
        except (ValueError, KeyError, ZeroDivisionError) as e:
            print(f"skipping {fn}: {e}")
            return
        if not self.is_in_range(score):
            return
        total_beats = int(score.highest_time)
        semis = self.all_transposition_intervals(score)
        md = self.get_metadata_tensor(score)

        transposed_leads = None
        if native is not None:
            with open(path) as f:
                text = f.read()
            rows = native.encode_transpositions(text, semis)
            if rows is not None and all(r is not None for r in rows):
                transposed_leads = rows
        if transposed_leads is None:  # python fallback / canonical path
            transposed_leads = [
                self.get_score_tensor(score.transpose(s))[0] for s in semis
            ]

        for lead in transposed_leads:
            for off in range(
                -self.num_beats_per_bar, total_beats, self.seq_size_in_beats
            ):
                s = off * self.subdivision
                e = (off + self.seq_size_in_beats) * self.subdivision
                leads.append(
                    extract_with_padding(
                        lead, s, e, self.vocab.start_index, self.vocab.end_index
                    )
                )
                mds.append(extract_metadata_with_padding(md, s, e))
