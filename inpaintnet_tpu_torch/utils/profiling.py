"""Tracing and step timing (``inpaintnet_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` around the block (the card's
  kernels where there is one, the host's operators always), written as a
  Chrome trace, ``logdir/trace.json`` (loads in Perfetto or
  ``chrome://tracing``);
- ``device_event_durations(logdir, match)``: the durations of the device
  events of such a trace whose name holds ``match``, the direct measure of
  kernel time;
- ``StepTimer``: wall time of steps, warm-up skipped, with the p50 and the
  throughput in the caller's units (measures/s, the north-star metric);
  given a CUDA ``device`` it synchronises at each step's start and end, so
  the time is the card's work and not its enqueue.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import List, Optional

import torch

# Chrome-trace categories of device work (kernels, copies, fills)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace goes to ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_event_durations(logdir: str, match: str,
                           line_match: Optional[str] = None) -> List[float]:
    """Durations (ms) of the device events (``DEVICE_CATEGORIES``) whose name
    holds ``match`` in the traces under ``logdir``, sorted ascending;
    ``line_match`` keeps only the categories that hold it (``"kernel"``:
    kernels alone). A trace without a card has none."""
    out: List[float] = []
    for path in glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for ev in events:
            cat = ev.get("cat", "")
            if cat not in DEVICE_CATEGORIES or (line_match is not None and line_match not in cat):
                continue
            if match in ev.get("name", "") and "dur" in ev:
                out.append(float(ev["dur"]) / 1e3)
    return sorted(out)


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
