"""Each cell on the card at its own size: a short run is correct and
reports every metric it owes, and its control is not correct. Marked
``cuda``; skips off the card. Run on the card with
``python -m pytest perfbench/tests -m cuda``."""
import time

import pytest

from perfbench import core

CELLS = ["latent512.bulk", "arnn256.bulk", "latent512.interactive"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, spec, cell, trace):
    result, lines, loaded = core.run_cell(cell, 2**31 + 11, 1.0, trace, t0=time.perf_counter(),
                                          spec=spec)
    assert result["correct"], lines
    assert loaded == []
    owed = {m["name"] for m in core.metrics_of(spec, cell, trace)}
    assert set(result["metrics"]) == owed
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, spec, cell):
    result, lines, _ = core.run_cell(cell, 2**31 + 12, 1.0, False, t0=time.perf_counter(),
                                     spec=spec, variant="control")
    assert not result["correct"], lines
