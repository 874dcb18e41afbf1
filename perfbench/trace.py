"""The traced window of a ``--trace 1`` run and its reduction to one
timeline.

``Tracer`` wraps ``torch.profiler`` (host and device activity). The
benchmark's host spans (``make_request``, ``engine_call``, ``copy_out``,
and ``trace_window`` around the traced requests) are ``record_function``
labels, so they share the device's clock. A trace may lose the first
device records after it starts, so each starts with a lead: a pause on
the host, then short ``torch.cuda._sleep`` kernels and one of a few
milliseconds, all before ``trace_window`` opens (the lead of
``chip_smoke._profile_step``, copied).

``Timeline`` keeps the device's kernels, copies and sets inside the
window, merges them into busy intervals, and gives the busy seconds, the
idle gaps and the host span that was open in each.

The profiler stretches a graph of thousands of small kernels (on an
H100, an interactive request ran 14.3 ms traced, 7.0 untraced), so what the
device's idle time and the host's share of a call read comes from the
calls it does not trace: ``ReplayClock`` records a CUDA event on the
current stream before and after every CUDA graph replay (the engines
replay on it), and the seconds between each pair are the device's time in
that replay, gaps between the graph's nodes included.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time

import torch

LEAD_S = 0.02
LEAD_SPINS = 32
LEAD_SPIN_CYCLES = 1_000
LEAD_CYCLES = 20_000_000
SPANS = ("make_request", "engine_call", "copy_out")
WINDOW = "trace_window"


class Tracer:
    """Host spans, and the profiler over the traced part of a window."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self._prof = None
        self._window = None
        self.timeline = None

    def span(self, name: str):
        if self.enabled and self._prof is not None:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        time.sleep(LEAD_S)
        if self.cuda:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(LEAD_SPIN_CYCLES)
            torch.cuda._sleep(LEAD_CYCLES)
            torch.cuda.synchronize()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.timeline = Timeline(prof)


class ReplayClock:
    """While entered and ``enabled``, a CUDA event pair around every
    ``torch.cuda.CUDAGraph.replay``. ``mark()`` counts the pairs so far;
    ``seconds(a, b)`` is the device time of pairs ``a`` to ``b``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.pairs = []
        self._replay = None

    def __enter__(self):
        if self.enabled:
            replay = self._replay = torch.cuda.CUDAGraph.replay
            pairs = self.pairs

            def timed_replay(graph):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                replay(graph)
                b.record()
                pairs.append((a, b))

            torch.cuda.CUDAGraph.replay = timed_replay
        return self

    def __exit__(self, *exc):
        if self._replay is not None:
            torch.cuda.CUDAGraph.replay = self._replay
            self._replay = None

    def mark(self) -> int:
        return len(self.pairs)

    def seconds(self, a: int, b: int):
        if not self.enabled:
            return None
        if b > a:
            self.pairs[b - 1][1].synchronize()
        return sum(x.elapsed_time(y) for x, y in self.pairs[a:b]) / 1e3


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _is_device_work(e) -> bool:
    """A kernel, copy or set, not the device's copy of a host label."""
    activity = getattr(e, "activity_type", None)
    if activity is not None:
        kind = str(activity()).lower()
        return ("kernel" in kind or "memcpy" in kind or "memset" in kind) and (
            "annotation" not in kind)
    label = getattr(e, "is_user_annotation", None)
    if label is not None and label():
        return False
    return e.name() not in SPANS and e.name() != WINDOW


class Timeline:
    """Device activity and host spans inside the traced window (ns on the
    profiler's clock)."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        spans, device = [], []
        for e in events:
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.name() in SPANS or e.name() == WINDOW:
                    spans.append((e.name(), start, end))
            elif _is_device_work(e) and "spin_kernel" not in e.name():
                device.append((e.name(), start, end))
        window = [s for s in spans if s[0] == WINDOW]
        self.window = (window[0][1], window[0][2]) if window else (0, 0)
        lo, hi = self.window
        self.spans = sorted((s for s in spans if s[0] != WINDOW and s[1] < hi and s[2] > lo),
                            key=lambda s: s[1])
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if s < hi and e > lo]
        self.busy = _merge([(s, e) for _, s, e in self.device])
        self._cum = [0]
        for s, e in self.busy:
            self._cum.append(self._cum[-1] + e - s)
        self._starts = [s for s, _ in self.busy]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self._cum[-1] / 1e9

    def busy_between(self, a: int, b: int) -> float:
        """Busy seconds of the device between ``a`` and ``b`` (ns)."""
        return (self._busy_before(b) - self._busy_before(a)) / 1e9

    def _busy_before(self, t: int) -> int:
        i = bisect.bisect_right(self._starts, t)
        if i == 0:
            return 0
        s, e = self.busy[i - 1]
        return self._cum[i - 1] + min(e, t) - s

    def kernels(self, patterns) -> list:
        """(name, seconds) of each device record whose name matches one of
        the regular expressions ``patterns``."""
        rx = [re.compile(p) for p in patterns]
        return [(n, (e - s) / 1e9) for n, s, e in self.device if any(r.search(n) for r in rx)]

    def launches(self) -> int:
        """Kernels the device ran in the window."""
        return sum(1 for n, _, _ in self.device if not n.lower().startswith("memcpy")
                   and not n.lower().startswith("memset"))

    def idle_gaps(self) -> list:
        """(host span, seconds) of each part of the window's idle gaps: a
        gap is split among the benchmark's spans it overlaps, the rest is
        "between_spans"."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        out, j = [], 0
        for a, b in zip(edges[::2], edges[1::2]):
            while j < len(self.spans) and self.spans[j][2] <= a:
                j += 1
            k, t = j, a
            while t < b:
                if k < len(self.spans) and self.spans[k][1] < b:
                    name, s, e = self.spans[k]
                    if s > t:
                        out.append(("between_spans", (s - t) / 1e9))
                        t = s
                    end = min(e, b)
                    if end > t:
                        out.append((name, (end - t) / 1e9))
                        t = end
                    k += 1
                else:
                    out.append(("between_spans", (b - t) / 1e9))
                    t = b
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing."""
        ops, idle = {}, {}
        for n, s, e in self.device:
            ops[n] = ops.get(n, 0) + (e - s) / 1e9
        for name, sec in self.idle_gaps():
            idle[name] = idle.get(name, 0.0) + sec
        return {"device_ops": [[n[:160], v] for n, v in
                               sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]
