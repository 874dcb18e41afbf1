"""CUDA-graph replay of the serving engines' fixed-shape calls.

The JAX engines run ONE compiled fixed-shape program per batch bucket
(``inpaintnet_tpu/serve.py:5-9``, ``inpaintnet_tpu/serve_arnn.py:27-28``).
On the card the counterpart of such a program is a captured CUDA graph:
the host records a call's launches once and later calls replay them with
one launch. :class:`GraphSet` holds one graph per key (a method, its
bucket and whatever else fixes the call's launch sequence), each with

- its static inputs, which every call rewrites whole before the replay;
- the captured ``torch.cuda.CUDAGraph`` and its static outputs;
- the kernel launches its capture counted (the wrappers of
  ``ops.kernel_common.LAUNCH_COUNTERS``), and the counts of
  ``utils.profiling``'s named counters (the encoder's and decoder's rows):
  every replay adds them to the wrappers' ``launches`` and to those
  counters, so a count means what it means on the eager route;
- the CUDA generator its batch-seed draws come from, registered with the
  graph and seeded before each replay with the seed the eager route seeds
  its own generator with: a replay draws what the eager call draws.

A key is captured at its first call. The call first runs once eagerly on
the static inputs, on the capture stream: that run fills every operand
cache (``kernel_common.WeightCache``, which refuses to build inside a
capture, and the wrappers' launch plans), and its result is the call's.
Then the same function is captured on that stream; later calls replay.
All of a set's graphs on one device share one memory pool
(``torch.cuda.graph_pool_handle``; a new one after a failed capture): a
caller holds :attr:`GraphSet.lock` from copy-in to copy-out, so no two of
them run at once, and a graph's outputs are read before another graph
runs. A capture that fails raises :class:`GraphCaptureError` naming its
key: nothing serves the call eagerly instead. :class:`GraphRouted` gives
both engines the switch between this route and the eager one.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from inpaintnet_tpu_torch.ops.kernel_common import LAUNCH_COUNTERS
from inpaintnet_tpu_torch.utils.profiling import count, counters, span


class GraphCaptureError(RuntimeError):
    """A key's capture failed (a host synchronisation inside the call, an
    operand built inside the capture, a launch the graph cannot hold)."""


def _launch_counts() -> list:
    return [w.launches for w in LAUNCH_COUNTERS]


class CapturedCall:
    """One key's graph, its static inputs and outputs, its generator (or
    None), the launches its capture counted ({wrapper: launches}) and its
    named counts ({counter: n}), and the seconds of its eager run and of
    its capture."""

    def __init__(self, graph, inputs, outputs, generator, launches: dict, counts: dict,
                 warm_s: float, capture_s: float):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.generator = generator
        self.launches = launches
        self.counts = counts
        self.warm_s = warm_s
        self.capture_s = capture_s


class GraphSet:
    """One engine's captured calls, by key (see the module docstring)."""

    def __init__(self):
        # held from copy-in to copy-out (re-entrant: a call may chain graphs)
        self.lock = threading.RLock()
        self._calls: Dict[object, CapturedCall] = {}
        self._pools: Dict[torch.device, object] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._every_pool: set = set()

    def __contains__(self, key) -> bool:
        return key in self._calls

    def __getitem__(self, key) -> CapturedCall:
        return self._calls[key]

    def keys(self) -> list:
        return list(self._calls)

    def call(self, key, device: torch.device, fn: Callable, inputs: Sequence[torch.Tensor],
             seed: Optional[int] = None):
        """``fn(*inputs, generator=g)`` on ``device`` through key's graph:
        ``inputs`` (tensors of the key's fixed shapes, on any device) are
        copied into its static inputs (span ``engine.copy_in``) and the graph
        replays (``engine.run``), ``g`` seeded with ``seed`` (None: ``g`` is
        None, the call draws no batch noise). A key's first call runs ``fn``
        eagerly and captures it. Returns the outputs (the graph's static
        tensors after a replay): read them while holding :attr:`lock`."""
        with self.lock, torch.cuda.device(device):
            entry = self._calls.get(key)
            if entry is None:
                return self._capture(key, device, fn, inputs, seed)
            with span("engine.copy_in", device):
                for static, x in zip(entry.inputs, inputs):
                    static.copy_(x)
            with span("engine.run", device):
                if entry.generator is not None:
                    entry.generator.manual_seed(seed)
                entry.graph.replay()
            for wrapper, n in entry.launches.items():
                wrapper.launches += n
            for name, n in entry.counts.items():
                count(name, n)
            return entry.outputs

    def _capture(self, key, device, fn, inputs, seed):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
            self._pools[device] = torch.cuda.graph_pool_handle()
            self._every_pool.add(tuple(self._pools[device]))
        stream = self._streams[device]
        statics = tuple(x.to(device).clone() for x in inputs)
        generator = None if seed is None else torch.Generator(device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), torch.inference_mode():
            if generator is not None:
                generator.manual_seed(seed)
            first = fn(*statics, generator=generator)
        torch.cuda.current_stream(device).wait_stream(stream)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before, named = _launch_counts(), counters()
        try:
            if generator is not None:
                graph.register_generator_state(generator)
            with torch.inference_mode(), torch.cuda.graph(
                    graph, pool=self._pools[device], stream=stream,
                    capture_error_mode="thread_local"):
                outputs = fn(*statics, generator=generator)
        except Exception as e:
            # a capture that failed mid-way may leave the allocator recording
            # into its pool: the device's next capture takes a new pool and
            # stream (the graphs captured so far keep theirs)
            del self._streams[device], self._pools[device]
            raise GraphCaptureError(f"capturing the CUDA graph of {key!r} failed: "
                                    f"{type(e).__name__}: {e}") from e
        finally:
            # the capture launched and computed nothing: its counts go to the
            # replays
            counted = {w: w.launches - b for w, b in zip(LAUNCH_COUNTERS, before)}
            for w, b in zip(LAUNCH_COUNTERS, before):
                w.launches = b
            counts = {k: n - named[k] for k, n in counters().items() if n != named[k]}
            for k, n in counts.items():
                count(k, -n)
        self._calls[key] = CapturedCall(graph, statics, outputs, generator,
                                        {w: n for w, n in counted.items() if n}, counts,
                                        t1 - t0, time.perf_counter() - t1)
        return first

    def held_bytes(self) -> int:
        """Bytes the card holds in this set's memory pools (their segments
        in ``torch.cuda.memory_snapshot()``): the graphs' outputs and the
        scratch their launches write."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in self._every_pool)


class GraphRouted:
    """The route of a serving engine (``serve.InpaintingEngine``,
    ``serve_arnn.ARNNServingEngine``): its ``graphs`` switch and its
    calls through :class:`GraphSet` or eagerly. The engine sets ``device``
    and calls :meth:`_init_graphs`."""

    def _init_graphs(self, graphs: Optional[bool]) -> None:
        self.graphs = graphs
        self._graphs = GraphSet()

    @property
    def graphs(self) -> bool:
        """Whether calls replay CUDA graphs: by default on a CUDA device,
        never elsewhere (True off the card raises ValueError). Settable, so
        one engine runs both routes over the same weights."""
        return self._use_graphs

    @graphs.setter
    def graphs(self, graphs: Optional[bool]) -> None:
        if graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, the engine runs on {self.device}")
        self._use_graphs = self.device.type == "cuda" if graphs is None else bool(graphs)

    def _call(self, key, device, fn: Callable, inputs: Sequence[torch.Tensor],
              seed: Optional[int] = None):
        """``fn(*inputs, generator=g)`` on ``device`` (call it holding
        ``self._graphs.lock`` and read the outputs before releasing it):
        through ``key``'s graph on the graph route, else eagerly on the
        inputs moved there (spans ``engine.copy_in``, ``engine.run``). ``g``
        draws the batch noise from ``seed`` (None: no generator)."""
        if self.graphs:
            return self._graphs.call(key, device, fn, inputs, seed)
        generator = None if seed is None else torch.Generator(device=device).manual_seed(seed)
        with span("engine.copy_in", device):
            inputs = [x.to(device) for x in inputs]
        with span("engine.run", device), torch.inference_mode():
            return fn(*inputs, generator=generator)
