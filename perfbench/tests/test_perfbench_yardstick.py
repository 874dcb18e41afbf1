"""The traffic generator, the operation counts and the trace's reduction."""
import numpy as np
import pytest
import torch

from conftest import small_parts
from perfbench import flops
from perfbench.generator import Traffic
from perfbench.trace import Timeline, _merge


@pytest.mark.parametrize("cell", ["latent512.bulk", "arnn256.bulk", "latent512.interactive"])
def test_traffic_is_deterministic_under_the_seed(cell):
    _, _, cfg, mix = small_parts(cell)
    a, b, c = Traffic(mix, cfg, 2**31 + 77), Traffic(mix, cfg, 2**31 + 77), Traffic(mix, cfg, 5)
    assert np.array_equal(a.pool, b.pool) and a.deck == b.deck
    for i in (0, 1, 17):
        ra, rb = a.request(i), b.request(i)
        assert ra["seed"] == rb["seed"] and np.array_equal(ra["tokens"], rb["tokens"])
        assert (ra["start_measure"], ra["num_measures"]) == (rb["start_measure"],
                                                              rb["num_measures"])
        assert np.array_equal(a.keep_rows(i), b.keep_rows(i))
    assert not np.array_equal(a.pool, c.pool)
    assert sorted(a.deck) == sorted(c.deck)  # the same spans, in another order


def test_interactive_spans_leave_past_and_future():
    _, _, cfg, mix = small_parts("latent512.interactive")
    t = Traffic(mix, cfg, 3)
    assert len(t.deck) == 14 + 13 + 12 + 11
    for start, num in t.deck:
        assert start >= 1 and start + num <= 15 and 1 <= num <= 4


def test_check_sample_holds_a_longest_span():
    _, _, cfg, mix = small_parts("latent512.interactive", check_rows=4)
    t = Traffic(mix, cfg, 9)
    kept = [{"num": 1}] * 50 + [{"num": 4}]
    sample = t.check_sample(kept)
    assert len(sample) == 4 and any(s["num"] == 4 for s in sample)


def test_frozen_counts_give_the_kernel_tables_bounds():
    k1 = flops.bound_s(flops.encoder_ops(65536, 24, 512), "bf16", 0)[0]
    k2 = flops.bound_s(flops.decode_ops(12288, 512, 60), "bf16", 0)[0]
    k7 = flops.bound_s(flops.arnn_ops(512, 384, 256, 256, 256, 60), "bf16", 0)[0]
    assert round(k1 * 1e3, 2) == 20.01
    assert round(k2 * 1e3, 2) == 1.50
    assert round(k7 * 1e3, 2) == 0.45


def test_needed_work_counts_only_present_measures():
    from perfbench.reference import latent_rnn
    _, _, cfg, _ = small_parts("latent512.bulk", widths={})
    req = {"tokens": np.zeros((2048, 16, 24), np.int32), "start_measure": 6, "num_measures": 4}
    work = latent_rnn.work(cfg, [req])
    assert work["k1"][0] == flops.encoder_ops(2048 * 12, 24, 512)
    assert work["k2"][0] == flops.decode_ops(2048 * 4, 512, 60)
    assert work["measures"] == 2048 * 4
    assert 9.5e12 < work["model_ops"] < 9.8e12


def test_merge_unions_overlapping_intervals():
    assert _merge([(5, 7), (0, 2), (1, 3), (7, 9), (10, 11)]) == [(0, 3), (5, 9), (10, 11)]


class _Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._d = name, start, end - start
        self._dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._n in ("engine_call", "trace_window")


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})})


def test_timeline_reads_busy_idle_and_host_time():
    events = [_Event("trace_window", 100, 1100, False),
              _Event("engine_call", 150, 650, False), _Event("engine_call", 700, 1050, False),
              _Event("engine_call", 150, 650, True),  # the label's device copy
              _Event("spin_kernel", 0, 120, True),  # the lead, before the window
              _Event("k_a", 200, 400, True), _Event("k_b", 300, 500, True),
              _Event("Memcpy DtoH", 500, 550, True), _Event("k_a", 800, 1000, True)]
    t = Timeline(_Prof(events))
    assert t.window_s == 1000 / 1e9
    assert t.busy_s == (350 + 200) / 1e9
    assert t.launches() == 3
    assert abs(t.busy_between(150, 650) - 350 / 1e9) < 1e-15
    gaps = dict(t.breakdown()["idle_gaps"])
    # [100, 200): 50 before the first call, 50 in it; [550, 800): 100 in
    # the first call, 50 between, 100 in the second; [1000, 1100): 50, 50
    assert abs(gaps["engine_call"] - (50 + 100 + 100 + 50) / 1e9) < 1e-15
    assert abs(gaps["between_spans"] - (50 + 50 + 50) / 1e9) < 1e-15
    ops = dict(t.breakdown()["device_ops"])
    assert abs(ops["k_a"] - 400 / 1e9) < 1e-15
