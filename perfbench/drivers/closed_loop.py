"""closed_loop: one client, one request a call, the next sent when the
last one returned, until the window's seconds have passed and the calls
fill the check's sample.

The window's time is the host's clock from the first call's start to the
last call's return, and every call in it counts. With ``trace`` the
profiler records the mix's ``trace_requests`` calls, after ``TRACE_AFTER``
untraced ones; the calls outside those are each timed as a cycle (host
clock) and by the replay clock's CUDA events, for the metrics that the
traced calls would stretch.

A mix names this driver with ``"driver": "closed_loop"`` and takes the
generator's keys (``generator.py``) and no others.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.core import Call, Window
from perfbench.generator import Traffic

KEYS = frozenset()  # mix keys this driver reads beyond the generator's
TRACE_AFTER = 2  # untraced calls before the traced ones
# seconds of the cell's calls after the capture: without them the first
# seconds of a window ran 8-12% slower on the card
WARM_S = 3.0


def traffic(mix: dict, cfg: dict, seed: int) -> Traffic:
    return Traffic(mix, cfg, seed, extra_keys=KEYS)


def warm(system, traffic: Traffic, cuda: bool) -> list:
    """The cell's one graph key captured and replayed, then ``WARM_S``
    seconds of its calls. -> (phase, end) marks."""
    import torch

    system.warmup(traffic.call(0), traffic.bucket)
    if cuda:
        torch.cuda.synchronize()
    marks = [("capture", time.perf_counter())]
    k = 1
    while cuda and time.perf_counter() < marks[-1][1] + WARM_S:
        system.call(traffic.call(k), traffic.bucket)
        k += 1
    marks.append(("warm-up", time.perf_counter()))
    return marks


def window(system, traffic: Traffic, seconds: float, *, tracer, clock, trace: bool,
           fault=None) -> Window:
    """The measured window. ``fault(requests, outputs)`` breaks the
    outputs where they are produced (tests)."""
    mix = traffic.mix
    w = Window()
    traced_calls = range(TRACE_AFTER, TRACE_AFTER + mix["trace_requests"]) if trace else range(0)
    # the window holds at least the calls whose kept rows fill the check
    enough = max(-(-mix["check_rows"] // mix["keep_per_call"]), traced_calls.stop)
    k = 0
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while True:
        cycle_start = time.perf_counter()
        if k == traced_calls.start and trace:
            tracer.start()
        with tracer.span("make_request"):
            requests = traffic.call(k)
        w.attempted += len(requests)
        lo = clock.mark()
        sent = time.perf_counter()
        try:
            with tracer.span("engine_call"):
                outs = system.call(requests, traffic.bucket)
        except Exception as e:  # a failed call counts; the run goes on
            w.failed += len(requests)
            w.lines.append(f"call {k} failed: {type(e).__name__}: {e}")
            outs = None
        end = time.perf_counter()
        hi = clock.mark()
        if outs is not None:
            if fault is not None:
                fault(requests, outs)
            with tracer.span("copy_out"):
                req = requests[0]
                for j in traffic.keep_rows(k):
                    w.kept.append({"tokens": req["tokens"][j], "start": req["start_measure"],
                                   "num": req["num_measures"], "seed": req["seed"],
                                   "row": int(j), "out": np.array(outs[0][j])})
            w.latencies += [end - sent] * len(requests)
            w.served += requests
            w.measures += sum(r["num_measures"] * len(r["tokens"]) for r in requests)
        if k in traced_calls:
            w.traced += requests
            if k == traced_calls.stop - 1:
                tracer.stop()
        elif trace and outs is not None:
            w.calls.append(Call(requests, time.perf_counter() - cycle_start, end - sent,
                                (lo, hi)))
        k += 1
        if end >= deadline and k >= enough:
            break
    w.window_s = end - start
    return w
