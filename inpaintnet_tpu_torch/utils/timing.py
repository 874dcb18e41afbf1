"""Device timing (``inpaintnet_tpu/utils/timing.py``).

PyTorch returns before the card has finished, so a host clock around
calls measures their enqueue. ``device_timeit`` times calls on the card
with CUDA events recorded on the current stream around the timed window
(and on the host clock when the outputs lie on the CPU); ``fetch`` reads a
small reduction of a result back to the host, which waits for it.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from inpaintnet_tpu_torch.models.base import iter_leaves


def _leaves(x):
    return [leaf for _, leaf in iter_leaves(x) if isinstance(leaf, torch.Tensor)]


def fetch(x) -> float:
    """The sum of every tensor of ``x`` (a tensor, or nested lists, tuples
    and dicts of them) in f32, read to the host: waits for the work that
    made them."""
    return float(sum(t.detach().float().sum().item() for t in _leaves(x)))


def device_timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                  reps: int = 1) -> float:
    """Seconds per call of ``fn(*args)``, the minimum over ``reps`` windows
    of ``iters`` calls each after ``warmup`` calls. Outputs on the card:
    CUDA events around each window (the card's time, start of the first
    call to end of the last); outputs on the CPU: the host clock, the last
    output fetched."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    fetch(out)
    on_card = any(t.is_cuda for t in _leaves(out))
    best = float("inf")
    for _ in range(reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            fetch(out)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return best
