"""The port's data layer (``inpaintnet_tpu_torch/data``) against the JAX
package's (``inpaintnet_tpu/data``), on the CPU: a copy, so every output
must be equal, not close.

Covered: the tokenizer goldens (``tests/goldens``) through the port's own
pipeline; each fixture tune parsed, tokenized, and written back to ABC and
to MIDI bytes; ``generate_corpus`` file for file at two seeds; the
metadata channels; ``FolkDatasetNBars`` arrays, vocabulary, ``repr`` and
``store_path``, with each package reading the cache the other wrote; the
native and Python tokenizer paths; the dataset registry; and a dataset
built in a fresh interpreter that never imports JAX.
"""
import gzip
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import inpaintnet_tpu.data as J
from inpaintnet_tpu.data import abc_writer as jax_abc_writer
from inpaintnet_tpu.data import midi as jax_midi
from inpaintnet_tpu.data.synthetic import generate_corpus as jax_generate_corpus
import inpaintnet_tpu_torch.data as P
from inpaintnet_tpu_torch.data import abc_writer, midi
from inpaintnet_tpu_torch.data import native as port_native
from inpaintnet_tpu_torch.data.synthetic import generate_corpus, generate_structured_tune

import tokenizer_goldens as G

REPO = Path(__file__).resolve().parents[1]


def _pipeline(text):
    """``tokenizer_goldens.pipeline`` on the port's modules."""
    score = P.parse_abc(text).fix_pick_up_measure().fix_last_measure()
    semis = P.all_transposition_semitones(score)
    tokens = {s: P.tokenizer.score_tokens(score.transpose(s)) for s in semis}
    vocab = P.Vocabulary.build(t for s in semis for t in tokens[s])
    encodings = {s: P.score_to_tensor(score.transpose(s), vocab).tolist() for s in semis}
    return score, semis, tokens, vocab, encodings


def _check_golden(text, g, label):
    score, semis, tokens, vocab, encodings = _pipeline(text)
    assert list(score.time_signature) == g["time_signature"], label
    assert list(score.pitch_range()) == g["pitch_range"], label
    assert int(score.highest_time * 6) == g["total_ticks"], label
    assert list(semis) == g["semitones"], label
    assert [vocab.token(i) for i in range(len(vocab))] == g["vocab"], label
    for s in semis:
        assert tokens[s] == g["tokens"][str(s)], (label, s)
        assert encodings[s] == g["encodings"][str(s)], (label, s)


def _fixtures():
    return {fn: (Path(G.FIX) / fn).read_text() for fn in sorted(os.listdir(G.FIX))
            if fn.endswith(".abc")}


def test_tokenizer_goldens():
    with open(G.GOLDEN_PATH) as f:
        tunes = json.load(f)["tunes"]
    assert set(tunes) == set(_fixtures())
    for fn, text in _fixtures().items():
        _check_golden(text, tunes[fn], fn)


def test_structured_tokenizer_goldens():
    """The 100 structured tunes frozen with their ABC text, and the port's
    generator giving that text again from the same seed."""
    import random

    with gzip.open(G.STRUCTURED_PATH, "rt") as f:
        tunes = json.load(f)["tunes"]
    rng = random.Random(100)
    for i in range(G.STRUCTURED_COUNT):
        g = tunes[str(i)]
        assert generate_structured_tune(rng, i, num_bars=16) == g["abc"], i
        _check_golden(g["abc"], g, i)


@pytest.mark.parametrize("fn", sorted(_fixtures()))
def test_fixture_parse_tokenize_and_write_equal_jax(fn):
    """Each fixture tune through both packages: the score's notes, every
    transposition's tokens and ids, the ABC text and MIDI bytes written
    back, and the tensor decoded to a score again."""
    text = _fixtures()[fn]
    ours = P.parse_abc(text).fix_pick_up_measure().fix_last_measure()
    theirs = J.parse_abc(text).fix_pick_up_measure().fix_last_measure()
    assert repr(ours.notes) == repr(theirs.notes)
    assert ours.time_signature == theirs.time_signature
    semis = P.all_transposition_semitones(ours)
    assert semis == J.all_transposition_semitones(theirs)
    tokens = [t for s in semis for t in P.tokenizer.score_tokens(ours.transpose(s))]
    assert tokens == [t for s in semis for t in J.tokenizer.score_tokens(theirs.transpose(s))]
    vocab, jvocab = P.Vocabulary.build(tokens), J.Vocabulary.build(tokens)
    assert vocab.index2note == jvocab.index2note
    for s in semis:
        ids = P.score_to_tensor(ours.transpose(s), vocab)
        jids = J.score_to_tensor(theirs.transpose(s), jvocab)
        assert ids.dtype == jids.dtype
        np.testing.assert_array_equal(ids, jids)
        back = P.tensor_to_score(ids, vocab)
        assert repr(back.notes) == repr(J.tensor_to_score(jids, jvocab).notes)
    assert abc_writer.write_abc(ours, title=fn) == jax_abc_writer.write_abc(theirs, title=fn)
    assert midi.score_to_midi_bytes(ours) == jax_midi.score_to_midi_bytes(theirs)


@pytest.mark.parametrize("seed", [3, 11])
def test_generate_corpus_equal_file_for_file(tmp_path, seed):
    generate_corpus(str(tmp_path / "port"), num_tunes=12, num_bars=16, seed=seed)
    jax_generate_corpus(str(tmp_path / "jax"), num_tunes=12, num_bars=16, seed=seed)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) >= 12
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


@pytest.mark.parametrize("fn", sorted(_fixtures()))
def test_metadata_tensor_equal_jax(fn):
    """``metadata_tensor`` over every channel kind (the beat marker as
    intended and with the reference's bug, ticks, and is-playing at two rest
    lengths), and the channels' ``generate``."""
    text = _fixtures()[fn]
    ours = P.parse_abc(text).fix_pick_up_measure().fix_last_measure()
    theirs = J.parse_abc(text).fix_pick_up_measure().fix_last_measure()
    for bug in (False, True):
        mds = [P.BeatMarkerMetadata(6, replicate_reference_bug=bug), P.TickMetadata(6),
               P.IsPlayingMetadata(1), P.IsPlayingMetadata(6)]
        jmds = [J.BeatMarkerMetadata(6, replicate_reference_bug=bug), J.TickMetadata(6),
                J.IsPlayingMetadata(1), J.IsPlayingMetadata(6)]
        got, want = P.metadata_tensor(ours, mds), J.metadata_tensor(theirs, jmds)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for m, jm in zip(mds, jmds):
            assert (m.name, m.num_values) == (jm.name, jm.num_values)
            np.testing.assert_array_equal(m.generate(100), jm.generate(100))


def _nbars(pkg, corpus, cache, **kw):
    mgr = pkg.DatasetManager(cache_dir=str(cache), corpus_dir=str(corpus))
    return mgr.get_dataset("folk_4by4nbars_short", metadatas=[pkg.BeatMarkerMetadata(6),
                                                              pkg.TickMetadata(6)], **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus")
    generate_corpus(str(path), num_tunes=6, num_bars=16, seed=5)
    return path


@pytest.mark.parametrize("train,num_bars", [(True, 16), (False, 9)])
def test_folk_dataset_nbars_equal_and_caches_shared(corpus, tmp_path, train, num_bars):
    """Built apart, the two packages' datasets give the same arrays,
    vocabulary, split, ``repr`` and ``store_path``; then each reads the
    cache the other wrote (a port dataset over JAX's cache directory, and
    the reverse) and gets the same arrays."""
    kw = dict(num_bars=num_bars, train=train)
    ours = _nbars(P, corpus, tmp_path / "port", **kw)
    theirs = _nbars(J, corpus, tmp_path / "jax", **kw)
    assert repr(ours) == repr(theirs)
    assert (os.path.relpath(ours.store_path, tmp_path / "port")
            == os.path.relpath(theirs.store_path, tmp_path / "jax"))
    assert ours.dataset_filenames == theirs.dataset_filenames
    for a, b in zip(ours.arrays, theirs.arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.note2index_dicts == theirs.note2index_dicts
    assert ours.index2note_dicts == theirs.index2note_dicts
    assert (Path(ours.vocab_path).read_bytes() == Path(theirs.vocab_path).read_bytes())
    # each reads the other's cache: the store exists, so nothing is rebuilt
    ours_on_jax = _nbars(P, corpus, tmp_path / "jax", **kw)
    theirs_on_port = _nbars(J, corpus, tmp_path / "port", **kw)
    assert os.path.exists(ours_on_jax.store_path) and os.path.exists(theirs_on_port.store_path)
    for a, b, c in zip(ours_on_jax.arrays, theirs_on_port.arrays, theirs.arrays):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    train_j, val_j, _ = theirs.data_loaders(batch_size=8, seed=2)
    train_p, val_p, _ = ours.data_loaders(batch_size=8, seed=2)
    for lp, lj in ((train_p, train_j), (val_p, val_j)):
        assert len(lp) == len(lj)
        for bp, bj in zip(lp, lj):
            for a, b in zip(bp, bj):
                np.testing.assert_array_equal(a, b)


def test_native_and_python_tokenizers_give_equal_arrays(corpus, tmp_path, monkeypatch):
    """The shared C++ tokenizer (loaded from the repository's ``native/``)
    and, with ``INPAINTNET_NATIVE=0``, the Python tokenizer build the same
    arrays as the JAX package."""
    if not port_native.NativeTokenizer.available():
        pytest.skip("the native tokenizer library could not be built here")
    native = _nbars(P, corpus, tmp_path / "native", num_bars=16)
    assert native._native_tokenizer() is not None
    native_arrays = native.arrays  # built now, on the native path
    monkeypatch.setenv("INPAINTNET_NATIVE", "0")
    monkeypatch.setattr(port_native, "_lib", None)
    assert not port_native.NativeTokenizer.available()
    python = _nbars(P, corpus, tmp_path / "python", num_bars=16)
    assert python._native_tokenizer() is None
    theirs = _nbars(J, corpus, tmp_path / "jax", num_bars=16)
    for a, b, c in zip(native_arrays, python.arrays, theirs.arrays):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_native_library_path_is_the_repository_native_dir():
    assert Path(port_native._LIB_DIR) == REPO / "native"


def test_dataset_registry_equal_jax(tmp_path):
    assert list(P.ALL_DATASETS) == list(J.ALL_DATASETS)
    for name, spec in P.ALL_DATASETS.items():
        jspec = J.ALL_DATASETS[name]
        assert spec.dataset_class.__name__ == jspec.dataset_class.__name__, name
        assert (spec.num_elements, spec.time_sigs) == (jspec.num_elements, jspec.time_sigs)
    with pytest.raises(ValueError, match="not registered"):
        P.DatasetManager(cache_dir=str(tmp_path), corpus_dir=str(tmp_path)).get_dataset("nope")


def test_exports_equal_jax():
    """The packages' ``__init__`` exports (submodules left out: which of
    them are attributes depends on what ran before)."""
    import inspect

    def exports(pkg):
        return {n for n in dir(pkg) if not n.startswith("_")
                and not inspect.ismodule(getattr(pkg, n))}

    assert exports(P) == exports(J) and len(exports(P)) >= 30


def test_dataset_built_without_jax(tmp_path, corpus):
    """A fresh interpreter builds a ``FolkDatasetNBars`` from
    ``generate_corpus`` with the port alone: neither JAX nor the JAX package
    is imported, and its ``repr`` and arrays equal the JAX package's."""
    code = textwrap.dedent(f"""
        import hashlib, sys
        from inpaintnet_tpu_torch.data import BeatMarkerMetadata, DatasetManager, TickMetadata
        from inpaintnet_tpu_torch.data.synthetic import generate_corpus
        generate_corpus({str(tmp_path / 'c')!r}, num_tunes=6, num_bars=16, seed=5)
        ds = DatasetManager(cache_dir={str(tmp_path / 'cache')!r},
                            corpus_dir={str(tmp_path / 'c')!r}).get_dataset(
            "folk_4by4nbars_short", metadatas=[BeatMarkerMetadata(6), TickMetadata(6)],
            num_bars=16)
        digest = hashlib.sha1(b"".join(a.tobytes() for a in ds.arrays)).hexdigest()
        assert not [m for m in sys.modules if m in ("jax", "inpaintnet_tpu")
                    or m.startswith(("jax.", "inpaintnet_tpu."))]
        print(repr(ds))
        print(digest)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    theirs = _nbars(J, corpus, tmp_path / "jax", num_bars=16)
    import hashlib

    want = hashlib.sha1(b"".join(a.tobytes() for a in theirs.arrays)).hexdigest()
    assert res.stdout.splitlines() == [repr(theirs), want]
