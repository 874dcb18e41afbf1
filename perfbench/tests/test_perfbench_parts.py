"""Parts found by name: a traffic mix's driver, and a metric's reader
shared by the names that start alike; the readers of the untraced calls."""
import time

import pytest

from conftest import ROOT, small_parts
from perfbench import core
from perfbench.generator import Traffic

SECOND_DRIVER = '''
from perfbench.drivers import closed_loop
from perfbench.generator import Traffic

KEYS = frozenset({"label"})


def traffic(mix, cfg, seed):
    return Traffic(mix, cfg, seed, extra_keys=KEYS)


warm = closed_loop.warm


def window(system, traffic, seconds, **kw):
    w = closed_loop.window(system, traffic, seconds, **kw)
    w.lines.append("driven by " + traffic.mix["label"])
    return w
'''


def test_a_mix_drives_its_window_with_the_driver_it_names(tmp_path, monkeypatch):
    (tmp_path / "labelled.py").write_text(SECOND_DRIVER)
    monkeypatch.setitem(core.DIRS, "drivers", tmp_path)
    parts = small_parts("latent512.interactive", driver="labelled", label="a second driver")
    result, lines, _ = core.run_cell("latent512.interactive", 2**31 + 5, 0.2, False,
                                     t0=time.perf_counter(), device="cpu", parts=parts)
    assert "driven by a second driver" in lines
    assert result["correct"], lines


def test_a_key_no_driver_reads_is_refused():
    _, _, cfg, mix = small_parts("latent512.interactive", label="x")
    with pytest.raises(ValueError, match="label"):
        Traffic(mix, cfg, 1)
    Traffic(mix, cfg, 1, extra_keys={"label"})


@pytest.mark.parametrize("name, file", [
    ("idle_share.bulk", "idle_share.py"), ("idle_share.some_later_cell", "idle_share.py"),
    ("mfu.arnn_bulk", "mfu.py"), ("measures_per_s.arnn", "measures_per_s.py"),
    ("measures_per_s", "measures_per_s.py"), ("k1_roofline", "k1_roofline.py")])
def test_a_metric_without_a_file_takes_the_reader_of_its_first_part(name, file):
    assert core.find("metrics", name) == ROOT / "perfbench" / "metrics" / file


def _ctx(calls):
    ctx = core.Context(calls=calls, calls_work={"model_ops": 6.0e12}, kind="bf16")
    return ctx


def _call(rows, cycle_s, call_s, replay_s):
    c = core.Call([{"tokens": [0] * rows}], cycle_s, call_s, (0, 0))
    c.replay_s = replay_s
    return c


def _read(metric, ctx):
    return core.load_module(core.find("metrics", metric)).read(ctx)


def test_untraced_call_readers():
    ctx = _ctx([_call(1, 0.010, 0.0095, 0.009), _call(1, 0.030, 0.0285, 0.027)])
    assert _read("idle_share.x", ctx) == pytest.approx(10.0)
    assert _read("host_ms_per_request", ctx) == pytest.approx(1.0)
    assert _read("mfu.x", ctx) == pytest.approx(100.0 * 6.0e12 / (0.04 * 989e12), rel=1e-3)


def test_untraced_call_readers_read_nothing_without_replays():
    ctx = _ctx([_call(1, 0.010, 0.0095, None)])
    assert _read("idle_share.x", ctx) is None
    assert _read("host_ms_per_request", ctx) is None
    assert _read("idle_share.x", _ctx([])) is None
