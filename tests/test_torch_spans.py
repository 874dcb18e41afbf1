"""The port's spans and counters (``inpaintnet_tpu_torch/utils/profiling.py``)
inside its serving engines: off, a span is the shared null context and an
engine call records nothing; on, each engine call records its steps in
order under one ``engine.call``; the buffer holds at its cap; the encoder's
and decoder's row counters against hand counts. On the card (marked
``cuda``, skipped elsewhere) a graph replay adds its capture's counts and
its ``engine.run`` events read device time. Imports no JAX, so the card
test runs on a machine without it:

    python -m pytest tests/test_torch_spans.py -m cuda -q --noconftest
"""
import sys
import threading

import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
from inpaintnet_tpu_torch.models.presets import ARNNDataset, build_flagship
from inpaintnet_tpu_torch.serve import InpaintingEngine
from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine
from inpaintnet_tpu_torch.utils import profiling
from inpaintnet_tpu_torch.utils.profiling import count, counters, records, set_spans, span

VOCAB = 30
N_BARS = 16
ENGINE_SPANS = ["engine.call", "engine.validate", "engine.pack", "engine.copy_in", "engine.run",
                "engine.copy_out", "engine.scatter"]


@pytest.fixture(autouse=True)
def _spans_off_after():
    """One intra-op thread (the tests' tiny eager ops), and spans off
    after each test, as every other test expects them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    set_spans(False)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def latent():
    return build_flagship(vocab_size=VOCAB, hidden=16, z_dim=8, emb=6, seed=0, device="cpu")[2]


@pytest.fixture(scope="module")
def arnn():
    return AnticipationRNNBaseline(
        ARNNDataset(VOCAB), note_embedding_dim=8, metadata_embedding_dim=4,
        num_lstm_constraints_units=16, num_lstm_generation_units=16, linear_hidden_size=16,
        num_layers=2, unary_constraint=True, device="cpu", seed=0)


def _tokens(b, m=N_BARS, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, m, 24)).astype(np.int32)


def _request(b, start, num, seed=0):
    return {"tokens": _tokens(b, seed=seed), "start_measure": start, "num_measures": num,
            "seed": seed}


def _tree(recs):
    return [(r.name, r.parent, r.call) for r in recs]


def test_spans_off_are_one_shared_null_context(latent):
    set_spans(True)
    set_spans(False)
    assert span("engine.call") is span("engine.run") is profiling._NULL
    assert span("not a span") is profiling._NULL  # off: not even the name is read
    engine = InpaintingEngine(latent, batch_buckets=(4,), dtype="float32", n_bars=N_BARS,
                              device="cpu")
    engine.inpaint_hetero([_request(2, 6, 4)])
    engine.inpaint(_tokens(2), 6, 4, seed=1)
    assert records() == []


def test_latent_engine_records_its_steps_under_one_call(latent):
    engine = InpaintingEngine(latent, batch_buckets=(4,), dtype="float32", n_bars=N_BARS,
                              device="cpu")
    set_spans(True)
    engine.inpaint_hetero([_request(2, 6, 4), _request(1, 3, 2, seed=1)])
    engine.inpaint(_tokens(3), 6, 4, seed=1)
    recs = records()
    assert [r.name for r in recs] == ENGINE_SPANS * 2
    assert _tree(recs) == ([("engine.call", None, 0)] + [(n, 0, 0) for n in ENGINE_SPANS[1:]]
                           + [("engine.call", None, 1)]
                           + [(n, 7, 1) for n in ENGINE_SPANS[1:]])
    for r in recs:
        parent = recs[r.parent] if r.parent is not None else None
        assert 0 < r.start_ns <= r.end_ns and not r.profiled and r.device_ms is None
        if parent is not None:
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    children = [r for r in recs if r.parent == 0]
    assert all(a.end_ns <= b.start_ns for a, b in zip(children, children[1:]))


def test_arnn_engine_records_its_steps_under_one_call(arnn):
    engine = ARNNServingEngine(arnn, batch_buckets=(1, 4), dtype="float32", max_measures=8,
                               device="cpu")
    set_spans(True)
    engine.inpaint_hetero([{"tokens": _tokens(2, 8), "start_measure": 2, "num_measures": 3},
                           {"tokens": _tokens(1, 7, 1), "start_measure": 1,
                            "num_measures": 4}])
    # coalescing validates and packs the requests, then the batch; the
    # batch's span is scattered, then the requests' outputs split
    assert _tree(records()) == [("engine.call", None, 0)] + [(n, 0, 0) for n in (
        "engine.validate", "engine.pack", "engine.validate", "engine.pack", "engine.copy_in",
        "engine.run", "engine.copy_out", "engine.scatter", "engine.scatter")]
    set_spans(True)
    engine.inpaint(_tokens(6, 8), 2, 3)  # chunks of 4 and 2, one call
    chunk = ["engine.pack", "engine.copy_in", "engine.run", "engine.copy_out",
             "engine.scatter"]
    assert [r.name for r in records()] == (["engine.call", "engine.validate", "engine.validate"]
                                           + chunk + ["engine.validate"] + chunk)
    assert {(r.call, r.parent) for r in records()[1:]} == {(0, 0)}


def test_spans_label_the_profilers_timeline(latent):
    engine = InpaintingEngine(latent, batch_buckets=(1,), dtype="float32", n_bars=N_BARS,
                              device="cpu")
    set_spans(True)
    engine.inpaint_hetero([_request(1, 2, 1)])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.inpaint_hetero([_request(1, 2, 1)])
    engine.inpaint_hetero([_request(1, 2, 1)])
    assert [r.profiled for r in records() if r.name == "engine.call"] == [False, True, False]
    labels = {e.key for e in prof.key_averages()}
    assert set(ENGINE_SPANS) <= labels


def test_the_buffer_holds_at_its_cap(latent, monkeypatch):
    engine = InpaintingEngine(latent, batch_buckets=(1,), dtype="float32", n_bars=N_BARS,
                              device="cpu")
    monkeypatch.setattr(profiling, "MAX_RECORDS", 10)
    set_spans(True)
    for _ in range(3):
        engine.inpaint_hetero([_request(1, 2, 1)])
    recs = records()
    assert [r.name for r in recs] == ENGINE_SPANS + ENGINE_SPANS[:3]
    assert [r.index for r in recs] == list(range(10))
    assert {r.call for r in recs} == {0, 1}


def test_turning_spans_on_starts_afresh_and_names_are_checked():
    count("encoder.rows", 5)
    with pytest.raises(KeyError):
        count("encoder.rowz", 1)
    set_spans(True)
    assert set(counters()) == set(profiling.COUNTERS)
    assert not any(counters().values()) and records() == []
    with pytest.raises(KeyError, match="engine.cal"):
        span("engine.cal")
    with span("engine.call"), span("engine.run"):
        set_spans(True)  # reset while open: the child starts a call of its own
        with span("engine.copy_out"):
            pass
    assert _tree(records()) == [("engine.copy_out", None, 0)]


def test_threads_lose_no_count_and_keep_their_own_parents():
    """Eight threads counting and opening spans at once, the interpreter
    switching threads every microsecond: no count is lost, and every span's
    parent is its own thread's open span, of the same call."""
    threads, rounds = 8, 2000
    set_spans(True)
    before = counters()["decoder.rows"]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                count("decoder.rows", 1)
                with span("engine.call"), span("engine.run"):
                    pass

        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert counters()["decoder.rows"] - before == threads * rounds
    recs = records()
    roots = [r for r in recs if r.name == "engine.call"]
    runs = [r for r in recs if r.name == "engine.run"]
    assert len(roots) == len(runs) == threads * rounds
    assert all(r.parent is None for r in roots)
    assert len({r.call for r in roots}) == threads * rounds
    assert all(recs[r.parent].name == "engine.call" and recs[r.parent].call == r.call
               for r in runs)
    assert sorted(recs[r.parent].index for r in runs) == [r.index for r in roots]


# each case: rows a request, its span, the bucket; the hand counts follow
# from them: 32 encoded slots (16 past, 16 future) and 6 decoded slots a row
# of the bucket, and a real row's present context and target measures
@pytest.mark.parametrize("rows, start, num, bucket", [
    (3, 6, 4, 4),    # the bulk cell's 6 / 4 / 6, one pad row
    (1, 1, 1, 1),    # interactive: 1 past, 14 future
    (1, 11, 4, 1),   # interactive: 11 past, 1 future
])
def test_row_counters_equal_the_hand_counts(latent, rows, start, num, bucket):
    engine = InpaintingEngine(latent, batch_buckets=(bucket,), dtype="float32", n_bars=N_BARS,
                              device="cpu")
    before = counters()
    engine.inpaint_hetero([_request(rows, start, num)])
    got = {k: v - before[k] for k, v in counters().items()}
    assert got == {"encoder.rows": 32 * bucket, "encoder.rows_needed": rows * (N_BARS - num),
                   "decoder.rows": 6 * bucket, "decoder.rows_needed": rows * num}


def test_variations_and_interpolation_count_only_the_rows_computed(latent):
    engine = InpaintingEngine(latent, batch_buckets=(4,), dtype="float32", n_bars=N_BARS,
                              device="cpu")
    before = counters()
    engine.inpaint_variations(_tokens(3), 6, 4, num_variations=2, seed=1)
    engine.interpolate(_tokens(1)[0, 0], _tokens(1)[0, 1], 5)
    got = {k: v - before[k] for k, v in counters().items()}
    # one encode of the bucket, a decode a variation; the interpolation
    # encodes its two measures and decodes 64 rows. Only inpaint and
    # inpaint_hetero count the rows their requests need
    assert got == {"encoder.rows": 32 * 4 + 2, "encoder.rows_needed": 0,
                   "decoder.rows": 2 * 6 * 4 + 64, "decoder.rows_needed": 0}


# --------------------------------------------------------------------------- #
# The card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_replay_adds_its_captures_counts_and_times_its_run(cuda):
    model = build_flagship(vocab_size=VOCAB, hidden=64, z_dim=8, emb=6, seed=0, device=cuda)[2]
    engine = InpaintingEngine(model, batch_buckets=(4,), dtype="bfloat16", n_bars=N_BARS,
                              device=cuda)
    request = [_request(3, 6, 4)]
    engine.graphs = False
    before = counters()
    engine.inpaint_hetero(request)
    eager = {k: v - before[k] for k, v in counters().items()}
    engine.graphs = True
    set_spans(True)
    for _ in range(3):  # the first runs eagerly and captures
        before = counters()
        engine.inpaint_hetero(request)
        assert {k: v - before[k] for k, v in counters().items()} == eager
    # the rows the graph computes; the engine counts the needed rows on the
    # host at every call
    assert engine._graphs[("hetero", 4, "xla", None)].counts == {
        "encoder.rows": 32 * 4, "decoder.rows": 6 * 4}
    recs = records()
    # the first call runs eagerly inside the capture, which opens no span
    assert [r.name for r in recs if r.call == 0] == [
        "engine.call", "engine.validate", "engine.pack", "engine.copy_out", "engine.scatter"]
    assert [r.name for r in recs if r.call == 2] == ENGINE_SPANS
    timed = {r.name: r.device_ms for r in recs if r.call == 2 and r.device_ms is not None}
    assert set(timed) == {"engine.copy_in", "engine.run", "engine.copy_out"}
    assert timed["engine.run"] > 0 and timed["engine.copy_out"] > 0
