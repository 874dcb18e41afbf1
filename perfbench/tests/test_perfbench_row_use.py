"""The readers of the program's row counters (``encoder_row_use.*``,
``decoder_row_use.*``): on hand-made counts, on a program without the
counters, and through a small traced run of each LatentRNN cell on the
CPU."""
import time

import pytest

from conftest import small_parts
from perfbench import core


def _read(metric):
    return core.load_module(core.find("metrics", metric)).read(core.Context())


@pytest.fixture
def profiling():
    from inpaintnet_tpu_torch.utils import profiling

    return profiling


def test_readers_on_hand_made_counts(profiling, monkeypatch):
    counts = {"encoder.rows": 65536, "encoder.rows_needed": 24576, "decoder.rows": 12288,
              "decoder.rows_needed": 8192}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert _read("encoder_row_use.bulk") == 37.5
    assert _read("decoder_row_use.interactive") == pytest.approx(200 / 3)
    counts.update({"encoder.rows": 0, "decoder.rows": 0})
    assert _read("encoder_row_use.bulk") is None and _read("decoder_row_use.bulk") is None


def test_readers_read_nothing_from_a_program_without_counters(profiling, monkeypatch):
    monkeypatch.delattr(profiling, "counters")
    assert _read("encoder_row_use.interactive") is None
    assert _read("decoder_row_use.bulk") is None


@pytest.mark.parametrize("cell, encoder, decoder", [
    ("latent512.bulk", 37.5, 200 / 3),  # 12 of 32 slots, 4 of 6, in every call
    # a deck of 50 spans dealt in turn: 13.6 of 32 and 2.4 of 6 over whole
    # decks; the run's calls end part way through one
    ("latent512.interactive", 42.5, 40.0),
])
def test_a_traced_run_reports_the_row_use(profiling, spec, cell, encoder, decoder):
    profiling.set_spans(True)  # starts the counters afresh
    profiling.set_spans(False)
    result, lines, _ = core.run_cell(cell, 2**31 + 31, 0.5, True, t0=time.perf_counter(),
                                     device="cpu", spec=spec, parts=small_parts(cell))
    assert result["correct"], lines
    got = {m: result["metrics"][f"{m}.{cell.split('.')[1]}"]["value"]
           for m in ("encoder_row_use", "decoder_row_use")}
    tol = 0 if cell.endswith("bulk") else 2.0
    assert got["encoder_row_use"] == pytest.approx(encoder, abs=tol)
    assert got["decoder_row_use"] == pytest.approx(decoder, abs=tol)
