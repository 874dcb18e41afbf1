"""Spans, counters and step timing (``inpaintnet_tpu/utils/profiling.py``).

- ``span(name, device=None)``: a context manager around one step of an
  engine call (the names are ``SPANS``). Spans are off by default, and
  then ``span`` is one flag test that returns one shared null context.
  ``set_spans(True)`` turns them on: each is then a :class:`Span` that
  records, in memory, its name, its host start and end
  (``time.perf_counter_ns``), the span open around it on its thread (its
  parent) and a call id that every span under one root shares, and whether
  ``torch.profiler`` was recording. While it records, the span is also a
  ``torch.profiler.record_function`` label, on the trace's timeline beside
  the kernels it launched. Given a CUDA ``device``, a span records a CUDA
  event at each end on the device's stream current at its start (events
  from a reused pool): ``records()`` reads their device milliseconds and
  returns the events to the pool, never the span itself. At most
  ``MAX_RECORDS`` spans are kept; later ones are not recorded.
- ``count(name, n)``: named integer counters (``COUNTERS``), always on,
  as the kernel wrappers' ``launches`` are; ``counters()`` reads them. A
  CUDA graph's capture moves the counts its Python made to its replays
  (``graphs.GraphSet``), so a replay counts what the eager call counts.
- ``StepTimer``: wall time of steps, warm-up skipped, with the p50 and the
  throughput in the caller's units (measures/s, the north-star metric);
  given a CUDA ``device`` it synchronises at each step's start and end, so
  the time is the card's work and not its enqueue.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

# every span of the program: an engine call (the root) and its steps, in the
# order they run
SPANS = ("engine.call", "engine.validate", "engine.pack", "engine.copy_in", "engine.run",
         "engine.copy_out", "engine.scatter")
# measures the frozen encoder and the decoder computed, and the ones the
# requests needed (their present context measures and their target measures)
COUNTERS = ("encoder.rows", "encoder.rows_needed", "decoder.rows", "decoder.rows_needed")
MAX_RECORDS = 1 << 16

_NULL = contextlib.nullcontext()
_on = False
_records: list = []
_counters: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
_calls = itertools.count()
# bumped by set_spans(True): a thread's stack of open spans from before is
# dropped at its next span
_epoch = 0
_free_events: Dict[torch.device, list] = {}
_local = threading.local()
_lock = threading.Lock()


class Span:
    """One span: a context manager while it is open, its record after.
    ``index`` is its place in ``records()`` (None if the full buffer did
    not record it), ``parent`` its parent's (None for a root), ``call`` the
    id every span under one root shares; ``end_ns`` is 0 while it is open;
    ``device_ms`` is the time between its CUDA events, read by
    ``records()`` (None without)."""
    __slots__ = ("name", "index", "parent", "call", "start_ns", "end_ns", "profiled",
                 "device_ms", "_device", "_events", "_label")

    def __init__(self, name: str, device=None):
        if name not in SPANS:
            raise KeyError(f"no span {name!r}; the spans are {SPANS}")
        self.name, self._device = name, device
        self.index = self.parent = self.call = self.device_ms = None
        self._events = self._label = None  # (stream, start, end); the profiler's label
        self.start_ns = self.end_ns = 0
        self.profiled = False

    def __enter__(self):
        if getattr(_local, "epoch", None) != _epoch:
            _local.epoch, _local.stack = _epoch, []
        stack = _local.stack
        parent = stack[-1] if stack else None
        self.profiled = torch.autograd._profiler_enabled()
        with _lock:
            if len(_records) >= MAX_RECORDS:
                return self
            self.index = len(_records)
            _records.append(self)
            self.parent, self.call = ((None, next(_calls)) if parent is None
                                      else (parent.index, parent.call))
        stack.append(self)
        if self.profiled:
            self._label = torch.profiler.record_function(self.name)
            self._label.__enter__()
        if self._device is not None and self._device.type == "cuda":
            stream = torch.cuda.current_stream(self._device)
            self._events = (stream, _event(stream.device), _event(stream.device))
            self._events[1].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.index is None:
            return False
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[2].record(self._events[0])
        if self._label is not None:
            self._label.__exit__(*exc)
        stack = _local.stack
        if stack and stack[-1] is self:  # else the spans were reset while it was open
            stack.pop()
        return False


def _event(device: torch.device):
    pool = _free_events.setdefault(device, [])
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


def _release(s: Span) -> None:
    stream, start, end = s._events
    _free_events.setdefault(stream.device, []).extend((start, end))
    s._events = None


def span(name: str, device=None):
    """A span of ``name`` (one of ``SPANS``), or the shared null context
    while spans are off. ``device``: a ``torch.device`` whose current
    stream the span's CUDA events go on (none off a CUDA device)."""
    if not _on:
        return _NULL
    return Span(name, device)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (one of ``COUNTERS``)."""
    with _lock:
        _counters[name] += n


def counters() -> Dict[str, int]:
    return dict(_counters)


def set_spans(on: bool) -> None:
    """Turn spans on or off. Turning them on starts afresh: the records,
    the counters, the call ids and every thread's open spans."""
    global _on, _records, _calls, _epoch
    if on:
        for s in _records:
            if s._events is not None and s.end_ns:
                _release(s)
        _records, _calls, _epoch = [], itertools.count(), _epoch + 1
        for name in _counters:
            _counters[name] = 0
    _on = bool(on)


def records() -> List[Span]:
    """Every span recorded since spans were last turned on, in the order
    they opened (a span still open reads end 0). Waits for the CUDA events
    of the closed spans not read before, reads their device milliseconds
    and returns the events to the pool."""
    out = list(_records)
    for s in out:
        if s._events is not None and s.end_ns:
            _, start, end = s._events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
            _release(s)
    return out


class StepTimer:
    """``with timer: step()`` times each step; the first ``warmup`` are
    left out of the statistics."""

    def __init__(self, items_per_step: float = 1.0, warmup: int = 1, device=None):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    @property
    def p50_ms(self) -> float:
        if not self._times:
            return float("nan")
        return sorted(self._times)[len(self._times) // 2] * 1e3

    @property
    def mean_s(self) -> float:
        if not self._times:
            return float("nan")
        return sum(self._times) / len(self._times)

    @property
    def throughput(self) -> float:
        m = self.mean_s
        return self.items_per_step / m if m > 0 else float("nan")

    def report(self, unit: str = "items") -> str:
        return (f"p50 {self.p50_ms:.2f} ms/step, "
                f"{self.throughput:.1f} {unit}/s over {len(self._times)} steps")
