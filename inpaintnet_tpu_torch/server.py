"""HTTP serving front end for :class:`inpaintnet_tpu_torch.serve.InpaintingEngine`.

The port's own copy of ``inpaintnet_tpu/server.py``: numpy and the
standard library only, duck-typed over the engine (it reads
``batch_buckets``, ``n_bars``, ``msl``, ``max_target``, ``_quant``,
``MAX_INTERP``, ``_compiled`` and ``model.vae_model.num_notes``, and calls
``inpaint``, ``inpaint_hetero``, ``inpaint_variations`` and
``interpolate``), with the same routes, batcher and error mapping. The
AnticipationRNN route serves an ``arnn_engine``
(:class:`inpaintnet_tpu_torch.serve_arnn.ARNNServingEngine`) and answers
400 on a server without one.

The reference has no serving layer; the product-level contract is the
tester generation API (latent_rnn_tester.py:131-195). This module is the
network front end for that contract: a stdlib ``ThreadingHTTPServer``
wrapping ONE engine. Concurrency model: request parsing/JSON runs
per-thread, but engine calls serialize on a lock — one process owns the
card and the device stream is in-order anyway, so the batching economy
comes from the engine's bucket machinery, not from concurrent dispatch.

Endpoints (JSON in/out):

- ``GET  /healthz`` -> ``{"status": "ok", "buckets": [...], ...}``
- ``GET  /v1/meta`` -> model geometry + vocab size
- ``POST /v1/inpaint``
  ``{"tokens": [[[..]]], "start_measure": i, "num_measures": n,
  "seed": optional}`` -> ``{"tokens": [[[..]]]}`` — tokens are
  (batch, measures, 24) int lists; a single (measures, 24) example is
  auto-batched and returned at its input rank.
- ``POST /v1/inpaint_variations`` — same plus ``"num_variations"``;
  returns ``{"variations": ...}`` of shape (variations, batch, measures,
  24) (or (variations, measures, 24) for a single example). Dispatched
  as nvar-tiled rows through the SAME hetero path as ``/v1/inpaint``
  (per-row keys), so variations coalesce with any traffic and
  variation 0 bit-equals the seeded ``/v1/inpaint`` response.
- ``POST /v1/inpaint_ticks`` — the reference tester's tick-range API:
  ``{"tokens": ..., "start_tick": t0, "end_tick": t1, "seed": optional}``.
- ``POST /v1/arnn/inpaint`` — the AnticipationRNN family (when the
  server holds an ``arnn_engine``): argmax constraint inpainting, or the
  reference's temperature sampling with ``"temperature"`` (both kinds
  coalesce under ``batching`` — sampled rows use per-row temperature
  vectors and (seed, row)-derived keys, grouped by decode kind).
- ``POST /v1/interpolate`` — latent interpolation between two measures
  (``measure_a``/``measure_b`` + ``num_points``; deterministic).
- ``GET  /metrics`` — Prometheus text format (request/status counters,
  latency histograms, coalesced-batch-size and batch-wait histograms).

Bulk transport: POSTs also accept ``Content-Type: application/x-npy``
with the raw ``.npy`` bytes of the tokens array as the body and the
scalar fields as query parameters (``?start_measure=6&num_measures=4``);
the response is then ``.npy`` bytes too. JSON encoding and decoding of
a large batch costs host time in proportion to its tokens, so bulk
traffic should use npy.

Errors: 400 with ``{"error": msg}`` for malformed/invalid requests, 404
for unknown paths, 500 for engine failures.
"""
from __future__ import annotations

import io
import json
import math
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["InpaintingServer"]

_MAX_BODY = 256 * 1024 * 1024


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib default listen backlog (5) drops/resets connections when
    # tens of clients connect in one burst — exactly the dynamic-batching
    # workload
    request_queue_size = 128


class _BadRequest(ValueError):
    pass


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.integer):
        return int(o)
    raise TypeError(f"not JSON-serializable: {type(o)}")


_INT_FIELDS = ("start_measure", "num_measures", "num_variations",
               "start_tick", "end_tick", "seed", "num_points")
_FLOAT_FIELDS = ("temperature",)


def _query_payload(query: str) -> dict:
    """Scalar fields from the query string (the npy transport's side
    channel for everything that isn't the tokens array)."""
    payload = {}
    for k, v in urllib.parse.parse_qsl(query):
        if k in _INT_FIELDS:
            try:
                payload[k] = int(v)
            except ValueError:
                raise _BadRequest(f"query parameter {k}={v!r} is not an int")
        elif k in _FLOAT_FIELDS:
            try:
                payload[k] = float(v)
            except ValueError:
                raise _BadRequest(f"query parameter {k}={v!r} is not a float")
        else:
            raise _BadRequest(f"unknown query parameter: {k}")
    return payload


def _parse_int_array(value, name: str = "tokens") -> np.ndarray:
    """Parse a request array as int32 WITHOUT silent wraparound: np.asarray
    with dtype=int32 wraps out-of-range int64 npy values (2**33+5 -> 5,
    which would then pass the vocab check) and raises OverflowError — not
    ValueError — for oversized JSON ints. Parse at natural precision,
    reject non-integer dtypes, range-check, then narrow."""
    try:
        arr = np.asarray(value)
    except (TypeError, ValueError):
        raise _BadRequest(f"{name} must be a (rectangular) int array")
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
        raise _BadRequest(f"{name} must be a (rectangular) int array")
    if arr.size and (int(arr.min()) < np.iinfo(np.int32).min
                     or int(arr.max()) > np.iinfo(np.int32).max):
        raise _BadRequest(f"{name} values exceed the int32 range")
    return arr.astype(np.int32)


def _get_tokens(payload, msl: int, vocab: Optional[int] = None):
    """Validate/shape the tokens field -> ((B, M, msl) int32, was_single)."""
    if "tokens" not in payload:
        raise _BadRequest("missing field: tokens")
    tokens = _parse_int_array(payload["tokens"])
    single = tokens.ndim == 2
    if single:
        tokens = tokens[None]
    if tokens.ndim != 3 or tokens.shape[-1] != msl:
        raise _BadRequest(
            f"tokens must be (batch, measures, {msl}) or (measures, {msl}); "
            f"got shape {tokens.shape}"
        )
    if tokens.size == 0:
        raise _BadRequest("tokens is empty")
    if vocab is not None and (tokens.min() < 0 or tokens.max() >= vocab):
        raise _BadRequest(f"token values must lie in [0, {vocab})")
    return tokens, single


def _get_flat_tokens(payload, msl: int, vocab: Optional[int] = None):
    """The tick-endpoint variant of :func:`_get_tokens`: ONE flat tick
    sequence -> ((1, L) int32, was_single). Same parse/error mapping."""
    if "tokens" not in payload:
        raise _BadRequest("missing field: tokens")
    tokens = _parse_int_array(payload["tokens"])
    single = tokens.ndim == 1
    if single:
        tokens = tokens[None]
    if tokens.ndim != 2 or tokens.shape[0] != 1 \
            or tokens.shape[1] == 0 or tokens.shape[1] % msl:
        raise _BadRequest(
            "tokens must be one flat tick sequence with length a "
            f"multiple of {msl}; got shape {tokens.shape}"
        )
    if vocab is not None and (tokens.min() < 0 or tokens.max() >= vocab):
        raise _BadRequest(f"token values must lie in [0, {vocab})")
    return tokens, single


def _get_int(payload, name, lo=None, hi=None):
    if name not in payload:
        raise _BadRequest(f"missing field: {name}")
    v = payload[name]
    if not isinstance(v, int) or isinstance(v, bool):
        raise _BadRequest(f"{name} must be an integer")
    if (lo is not None and v < lo) or (hi is not None and v > hi):
        raise _BadRequest(f"{name}={v} out of range [{lo}, {hi}]")
    return v


class _Metrics:
    """Lock-guarded request counters + latency/batch-size/batch-wait
    histograms, rendered in the Prometheus text exposition format at
    ``GET /metrics`` (no client-library dependency — the format is plain
    text)."""

    LAT_BUCKETS = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0, 5000.0)
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
    WAIT_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)

    def __init__(self):
        self.lock = threading.Lock()
        self.requests: dict = {}     # (route, status) -> count
        self.lat_hist: dict = {}     # route -> [len(LAT_BUCKETS)+1 counts]
        self.lat_sum: dict = {}      # route -> total ms
        self.batch_hist = [0] * (len(self.BATCH_BUCKETS) + 1)
        self.batch_sum = 0
        self.batch_count = 0
        self.wait_hist = [0] * (len(self.WAIT_BUCKETS) + 1)
        self.wait_sum = 0.0

    def observe(self, route: str, status: int, ms: float):
        with self.lock:
            key = (route, status)
            self.requests[key] = self.requests.get(key, 0) + 1
            hist = self.lat_hist.setdefault(
                route, [0] * (len(self.LAT_BUCKETS) + 1)
            )
            i = 0
            while i < len(self.LAT_BUCKETS) and ms > self.LAT_BUCKETS[i]:
                i += 1
            hist[i] += 1
            self.lat_sum[route] = self.lat_sum.get(route, 0.0) + ms

    def observe_batch(self, size: int):
        with self.lock:
            i = 0
            while (i < len(self.BATCH_BUCKETS)
                   and size > self.BATCH_BUCKETS[i]):
                i += 1
            self.batch_hist[i] += 1
            self.batch_sum += size
            self.batch_count += 1

    def observe_wait(self, ms: float):
        """One coalesced request's wait in the batcher's queue, from its
        enqueue to its batch's dispatch."""
        with self.lock:
            i = 0
            while i < len(self.WAIT_BUCKETS) and ms > self.WAIT_BUCKETS[i]:
                i += 1
            self.wait_hist[i] += 1
            self.wait_sum += ms

    def render(self) -> str:
        out = [
            "# HELP inpaintnet_requests_total Requests by route and status.",
            "# TYPE inpaintnet_requests_total counter",
        ]
        with self.lock:
            for (route, status), n in sorted(self.requests.items()):
                out.append(
                    f'inpaintnet_requests_total{{route="{route}",'
                    f'status="{status}"}} {n}'
                )
            out += [
                "# HELP inpaintnet_request_latency_ms Request latency.",
                "# TYPE inpaintnet_request_latency_ms histogram",
            ]
            for route, hist in sorted(self.lat_hist.items()):
                cum = 0
                for le, n in zip(self.LAT_BUCKETS, hist):
                    cum += n
                    out.append(
                        f'inpaintnet_request_latency_ms_bucket{{route='
                        f'"{route}",le="{le}"}} {cum}'
                    )
                cum += hist[-1]
                out.append(
                    f'inpaintnet_request_latency_ms_bucket{{route='
                    f'"{route}",le="+Inf"}} {cum}'
                )
                out.append(
                    f'inpaintnet_request_latency_ms_sum{{route="{route}"}} '
                    f'{self.lat_sum[route]:.3f}'
                )
                out.append(
                    f'inpaintnet_request_latency_ms_count{{route='
                    f'"{route}"}} {cum}'
                )
            if self.batch_count:
                out += [
                    "# HELP inpaintnet_coalesced_batch_size Requests per "
                    "coalesced device batch.",
                    "# TYPE inpaintnet_coalesced_batch_size histogram",
                ]
                cum = 0
                for le, n in zip(self.BATCH_BUCKETS, self.batch_hist):
                    cum += n
                    out.append(
                        f'inpaintnet_coalesced_batch_size_bucket{{le='
                        f'"{le}"}} {cum}'
                    )
                cum += self.batch_hist[-1]
                out.append(
                    f'inpaintnet_coalesced_batch_size_bucket{{le="+Inf"}} '
                    f'{cum}'
                )
                out.append(
                    f"inpaintnet_coalesced_batch_size_sum {self.batch_sum}"
                )
                out.append(
                    f"inpaintnet_coalesced_batch_size_count "
                    f"{self.batch_count}"
                )
                out += [
                    "# HELP inpaintnet_batch_wait_ms Time a coalesced request "
                    "waited in the batcher's queue, from enqueue to its "
                    "batch's dispatch.",
                    "# TYPE inpaintnet_batch_wait_ms histogram",
                ]
                cum = 0
                for le, n in zip(self.WAIT_BUCKETS, self.wait_hist):
                    cum += n
                    out.append(f'inpaintnet_batch_wait_ms_bucket{{le="{le}"}} {cum}')
                cum += self.wait_hist[-1]
                out.append(f'inpaintnet_batch_wait_ms_bucket{{le="+Inf"}} {cum}')
                out.append(f"inpaintnet_batch_wait_ms_sum {self.wait_sum:.3f}")
                out.append(f"inpaintnet_batch_wait_ms_count {cum}")
        return "\n".join(out) + "\n"


class _Slot:
    """One waiting request in the batcher's queue, stamped at its enqueue
    (``time.monotonic``)."""
    __slots__ = ("event", "result", "error", "enqueued")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueued = 0.0


class _Batcher:
    """Dynamic request coalescing: concurrent ``/v1/inpaint`` requests are
    drained from a queue into ONE :meth:`InpaintingEngine.inpaint_hetero`
    device call (per-row masks let heterogeneous spans share a batch;
    per-row PRNG keys make every response independent of which requests
    share its batch — see serve.py). The dispatcher waits up to
    ``max_wait_ms`` after the first request of a batch for co-travellers,
    so a lone request pays at most that much extra latency while a burst
    of N batch-1 requests pays ~one device step total instead of N.
    """

    _STOP = object()

    def __init__(self, engine, lock, max_wait_ms: float = 5.0,
                 max_rows: Optional[int] = None,
                 pin_bucket: Optional[int] = None,
                 metrics: Optional[_Metrics] = None,
                 group_key=None, dispatch=None):
        """:param group_key: optional ``request -> hashable`` — only
        requests with EQUAL keys share a batch (the ARNN engine's
        per-measure-count programs); mismatching arrivals are held over
        for their own batch. None = everything coalesces.
        :param dispatch: the coalesced engine call, default
        ``engine.inpaint_hetero(requests, bucket=pin_bucket)``."""
        self.engine = engine
        self.metrics = metrics
        self.lock = lock
        self.max_wait = max_wait_ms / 1e3
        self.pin_bucket = pin_bucket
        self.max_rows = (max_rows or pin_bucket
                         or engine.batch_buckets[-1])
        self.group_key = group_key or (lambda req: None)
        self.dispatch = dispatch or (
            lambda reqs: engine.inpaint_hetero(reqs, bucket=pin_bucket)
        )
        self.queue: queue.Queue = queue.Queue()
        self.calls = 0      # device batches dispatched
        self.requests = 0   # requests served through those batches
        self._pending: list = []  # held-over items (didn't fit / other group)
        self._stopped = False
        # closes the submit-vs-shutdown race: submit's stopped-check and
        # enqueue are atomic against _drain_fail's stopped-set and drain,
        # so an item is either drained (and failed) or rejected up front —
        # never enqueued into a dead batcher to wait forever
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: dict):
        """Enqueue one request dict (tokens/start_measure/num_measures/
        seed) and block until its batch has run. Raises the engine's
        exception if the batch failed, RuntimeError if the batcher is
        not running (stopped server / dead dispatcher) — never hangs on
        a dispatcher that cannot answer."""
        slot = _Slot()
        with self._submit_lock:
            if self._stopped or not self._thread.is_alive():
                raise RuntimeError("batcher is not running")
            slot.enqueued = time.monotonic()
            self.queue.put((request, slot))
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def stop(self):
        self._stopped = True
        self.queue.put(self._STOP)
        self._thread.join(timeout=5)

    @staticmethod
    def _rows(item) -> int:
        return item[0]["tokens"].shape[0]

    def _loop(self):
        try:
            while self._loop_once():
                pass
        finally:
            # dispatcher exiting (stop() or a non-Exception escape):
            # nothing may be left blocked on an answer that will never come
            # (_drain_fail sets _stopped under the submit lock)
            self._drain_fail(RuntimeError("batcher stopped"))

    def _drain_fail(self, exc: BaseException):
        with self._submit_lock:
            self._stopped = True
            items = list(self._pending)
            self._pending = []
            while True:
                try:
                    items.append(self.queue.get_nowait())
                except queue.Empty:
                    break
        for item in items:
            if item is self._STOP:
                continue
            _, slot = item
            slot.error = exc
            slot.event.set()

    def _loop_once(self) -> bool:
        first = self._pending.pop(0) if self._pending else self.queue.get()
        if first is self._STOP:
            return False
        batch = [first]
        try:
            rows = self._rows(first)
            key0 = self.group_key(first[0])
            # matching held-over items join first
            still_pending = []
            for item in self._pending:
                if (item is not self._STOP
                        and self.group_key(item[0]) == key0
                        and rows + self._rows(item) <= self.max_rows):
                    batch.append(item)
                    rows += self._rows(item)
                else:
                    still_pending.append(item)
            self._pending = still_pending
            # once STOP is held over, dispatch immediately — waiting the
            # full max_wait per remaining holdover group would let stop()
            # outlive its join timeout
            stopping = any(it is self._STOP for it in self._pending)
            deadline = time.monotonic() + (0 if stopping else self.max_wait)
            while rows < self.max_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if (nxt is self._STOP
                        or self.group_key(nxt[0]) != key0
                        or rows + self._rows(nxt) > self.max_rows):
                    self._pending.append(nxt)  # its own round later
                    if nxt is self._STOP:
                        break
                    continue
                batch.append(nxt)
                rows += self._rows(nxt)
            self.calls += 1
            self.requests += len(batch)
            if self.metrics is not None:
                self.metrics.observe_batch(len(batch))
                dispatched = time.monotonic()
                for _, slot in batch:
                    self.metrics.observe_wait(1e3 * (dispatched - slot.enqueued))
            with self.lock:
                outs = self.dispatch([req for req, _ in batch])
        except Exception as exc:  # noqa: BLE001 — fan the error out
            for _, slot in batch:
                slot.error = exc
                slot.event.set()
        else:
            for (_, slot), out in zip(batch, outs):
                slot.result = out
                slot.event.set()
        return True


class InpaintingServer:
    """Serve one :class:`InpaintingEngine` over HTTP.

    ``start()`` runs in a daemon thread and returns the bound port
    (pass ``port=0`` for an ephemeral one); ``serve_forever()`` blocks.

    With ``batching=True`` (non-autoregressive engines only), concurrent
    ``/v1/inpaint`` / ``/v1/inpaint_ticks`` requests coalesce into one
    device batch (see :class:`_Batcher`). Determinism contract: a
    response never depends on WHICH requests share its batch (per-row
    PRNG keys, serve.py), and for non-autoregressive engines both
    batching modes dispatch through the same ``inpaint_hetero`` RNG
    path — so a seeded request is reproducible across server restarts
    and batching settings AT A GIVEN BUCKET. The bucket is picked by
    total coalesced rows; different buckets are different padded device
    batches whose float results need not be bit-equal, so pass
    ``pin_bucket=<bucket>`` to run every coalesced batch at one fixed
    bucket and make seeded responses bit-identical under ANY load (at
    the cost of padded transfers). Requests that don't fit one hetero
    batch — larger than ``pin_bucket`` when set, else larger than the
    largest bucket — fall back to the engine's chunked batch-key path,
    whose seeded outputs differ from the hetero path's.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 quiet: bool = True, batching: bool = False,
                 max_wait_ms: float = 5.0,
                 pin_bucket: Optional[int] = None,
                 arnn_engine=None):
        """:param arnn_engine: optional AnticipationRNN serving engine,
        :class:`inpaintnet_tpu_torch.serve_arnn.ARNNServingEngine`
        (``batch_buckets``, ``max_measures``, ``measure_buckets``, ``msl``,
        ``model.num_notes``, ``length_bucket``, ``inpaint``,
        ``inpaint_hetero``) — serves the reference's AnticipationRNN
        inpainting family at ``POST /v1/arnn/inpaint`` next to the
        LatentRNN endpoints."""
        self.engine = engine
        self.arnn_engine = arnn_engine
        self.metrics = _Metrics()
        self._lock = threading.Lock()  # engine calls are serialized
        if pin_bucket is not None and pin_bucket not in engine.batch_buckets:
            raise ValueError(
                f"pin_bucket={pin_bucket} is not one of the engine's "
                f"buckets {list(engine.batch_buckets)}"
            )
        if (pin_bucket is not None and arnn_engine is not None
                and pin_bucket not in arnn_engine.batch_buckets):
            raise ValueError(
                f"pin_bucket={pin_bucket} is not one of the ARNN "
                f"engine's buckets {list(arnn_engine.batch_buckets)}"
            )
        self._pin_bucket = pin_bucket
        self._batcher = (
            _Batcher(engine, self._lock, max_wait_ms=max_wait_ms,
                     pin_bucket=pin_bucket, metrics=self.metrics)
            if batching else None
        )
        # ARNN requests coalesce too — argmax (no RNG) AND sampled
        # (per-row temperature + per-row (seed, row)-derived keys, so a
        # response never depends on its co-travellers; bit-exact vs solo
        # at a given bucket, and pin_bucket passes through for
        # bit-identity under any load). Grouped by (measure BUCKET,
        # decode kind): mixed-length requests within a measure bucket
        # share one program (per-row tick masks keep the padding exact),
        # and argmax/sampled are different programs
        # (serve_arnn.inpaint_hetero).
        self._arnn_batcher = (
            _Batcher(arnn_engine, self._lock, max_wait_ms=max_wait_ms,
                     metrics=self.metrics, pin_bucket=pin_bucket,
                     group_key=lambda req: (
                         arnn_engine.length_bucket(req["tokens"].shape[1]),
                         "temperature" in req,
                     ),
                     dispatch=lambda reqs: arnn_engine.inpaint_hetero(
                         reqs, bucket=pin_bucket))
            if batching and arnn_engine is not None else None
        )
        self._httpd = _HTTPServer((host, port), self._make_handler(quiet))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def serve_forever(self):
        self._httpd.serve_forever()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._batcher is not None:
            self._batcher.stop()
        if self._arnn_batcher is not None:
            self._arnn_batcher.stop()

    # ------------------------------------------------------------------ #

    def _meta(self) -> dict:
        e = self.engine
        vocab = e.model.vae_model.num_notes
        out = {
            "model": "LatentRNN",
            "n_bars": e.n_bars,
            "measure_seq_len": e.msl,
            "max_target": e.max_target,
            "vocab_size": vocab,
            "batch_buckets": list(e.batch_buckets),
            "quant": e._quant,
            "max_interp_points": e.MAX_INTERP,
        }
        if self.arnn_engine is not None:
            out["arnn"] = {
                "model": type(self.arnn_engine.model).__name__,
                "batch_buckets": list(self.arnn_engine.batch_buckets),
                "max_measures": self.arnn_engine.max_measures,
                "measure_buckets": list(self.arnn_engine.measure_buckets),
            }
        return out

    def _health(self) -> dict:
        out = {
            "status": "ok",
            "buckets": list(self.engine.batch_buckets),
            # snapshot via list() (atomic under the GIL) — POST threads
            # insert compile-cache entries concurrently, and iterating
            # the live dict could raise mid-/healthz
            "warmed": sorted(list(self.engine._compiled), key=str),
        }
        if self._batcher is not None:
            out["batching"] = {
                "calls": self._batcher.calls,
                "requests": self._batcher.requests,
                "max_wait_ms": self._batcher.max_wait * 1e3,
                "max_rows": self._batcher.max_rows,
            }
        if self._arnn_batcher is not None:
            out["arnn_batching"] = {
                "calls": self._arnn_batcher.calls,
                "requests": self._arnn_batcher.requests,
            }
        return out

    def _run_inpaint(self, tokens, start: int, num: int, seed):
        """Dispatch one inpaint: through the batcher when enabled (and the
        request fits a single device batch), else a locked engine call.
        Requests that fit a bucket ALWAYS go through the hetero
        per-row-key path (both generation configs — the autoregressive
        scan threads per-row keys too, LatentRNN.apply row_keys), so
        responses don't depend on the ``batching`` setting; only
        oversized requests use the engine's chunked batch-key path."""
        req = {"tokens": tokens, "start_measure": start,
               "num_measures": num, "seed": seed}
        if (self._batcher is not None
                and tokens.shape[0] <= self._batcher.max_rows):
            return self._batcher.submit(req)
        cap = (self._pin_bucket if self._pin_bucket is not None
               else self.engine.batch_buckets[-1])
        with self._lock:
            if tokens.shape[0] <= cap:
                return self.engine.inpaint_hetero(
                    [req], bucket=self._pin_bucket
                )[0]
            return self.engine.inpaint(tokens, start, num, seed=seed)

    def _inpaint(self, payload: dict) -> dict:
        e = self.engine
        tokens, single = _get_tokens(payload, e.msl,
                                     e.model.vae_model.num_notes)
        m = tokens.shape[1]
        if m > e.n_bars:
            # validate BEFORE enqueue: a bad request must 400 on its own,
            # not fail a coalesced batch it shares with others
            raise _BadRequest(
                f"tokens have {m} measures; the engine serves at most "
                f"{e.n_bars}"
            )
        num = _get_int(payload, "num_measures", 1, e.max_target)
        # >= 1: generation seeds from the last past measure's latent
        # (reference latent_rnn.py:148-151), so one past measure must exist
        start = _get_int(payload, "start_measure", 1, m - num)
        seed = payload.get("seed")
        if seed is not None and not isinstance(seed, int):
            raise _BadRequest("seed must be an integer")
        out = self._run_inpaint(tokens, start, num, seed)
        return {"tokens": out[0] if single else out}

    def _inpaint_variations(self, payload: dict) -> dict:
        e = self.engine
        tokens, single = _get_tokens(payload, e.msl,
                                     e.model.vae_model.num_notes)
        m = tokens.shape[1]
        if m > e.n_bars:
            raise _BadRequest(
                f"tokens have {m} measures; the engine serves at most "
                f"{e.n_bars}"
            )
        num = _get_int(payload, "num_measures", 1, e.max_target)
        start = _get_int(payload, "start_measure", 1, m - num)
        nvar = _get_int(payload, "num_variations", 1, 4096)
        seed = payload.get("seed")
        if seed is not None and not isinstance(seed, int):
            raise _BadRequest("seed must be an integer")
        b = tokens.shape[0]
        cap = (self._pin_bucket if self._pin_bucket is not None
               else e.batch_buckets[-1])
        if nvar * b <= cap:
            # a variations request is EXACTLY an inpaint request with
            # nvar-tiled rows: the hetero path's per-row keys
            # (derive_row_keys(seed, nvar*b)) already make every tiled
            # row a distinct draw — in BOTH generation configs — so
            # variations ride the SAME dispatch (and batcher) as
            # /v1/inpaint: coalescing with any traffic, bit-exact
            # solo-vs-coalesced, and variation 0 bit-equal to the seeded
            # /v1/inpaint response (shared key prefix).
            tiled = np.tile(tokens, (nvar, 1, 1))
            out = self._run_inpaint(tiled, start, num, seed)
            out = out.reshape((nvar, b) + tokens.shape[1:])
        else:
            # oversized: the engine's bulk path — encode-once
            # cached-posterior generation (a different RNG stream from
            # the hetero path; seeded reproducibility holds per path)
            with self._lock:
                out = e.inpaint_variations(tokens, start, num, nvar,
                                           seed=seed)
        # (variations, batch, measures, msl)
        return {"variations": out[:, 0] if single else out}

    def _inpaint_ticks(self, payload: dict) -> dict:
        """Reference tick-range contract (latent_rnn_tester.py:131-195):
        ONE flat tick sequence + a measure-aligned [start, end) range."""
        e = self.engine
        tokens, single = _get_flat_tokens(payload, e.msl,
                                          e.model.vae_model.num_notes)
        total = tokens.shape[1]
        if total // e.msl > e.n_bars:
            raise _BadRequest(
                f"sequence has {total // e.msl} measures; the engine "
                f"serves at most {e.n_bars}"
            )
        end = _get_int(payload, "end_tick", 1, total)
        # start >= msl: at least one past measure (see _inpaint)
        start = _get_int(payload, "start_tick", e.msl, end - 1)
        if start % e.msl or end % e.msl:
            raise _BadRequest(
                f"tick range must be measure-aligned (multiples of {e.msl})"
            )
        if (end - start) // e.msl > e.max_target:
            raise _BadRequest(
                f"tick range spans more than max_target={e.max_target} "
                "measures"
            )
        seed = payload.get("seed")
        if seed is not None and not isinstance(seed, int):
            raise _BadRequest("seed must be an integer")
        # always via _run_inpaint: the tick endpoint's RNG path must not
        # depend on the batching flag either
        out3 = self._run_inpaint(
            tokens.reshape(1, -1, e.msl), start // e.msl,
            (end - start) // e.msl, seed,
        )
        out = out3.reshape(1, -1)
        return {"tokens": out[0] if single else out}

    def _interpolate(self, payload: dict) -> dict:
        """Latent interpolation between two measures (the reference
        VAETester capability, vae_tester.py:72-93) — deterministic."""
        e = self.engine
        vocab = e.model.vae_model.num_notes
        if "tokens" in payload and "measure_a" not in payload:
            # npy transport ships ONE array: (2, msl) = [measure_a,
            # measure_b]; _parse_int_array so a ragged/non-int list is a
            # 400 like every other endpoint, not a 500
            t = _parse_int_array(payload["tokens"])
            if t.shape != (2, e.msl):
                raise _BadRequest(
                    f"tokens must be (2, {e.msl}) — the two measures to "
                    f"interpolate between; got shape {t.shape}"
                )
            payload = {**payload, "measure_a": t[0], "measure_b": t[1]}
        pair = []
        for name in ("measure_a", "measure_b"):
            if name not in payload:
                raise _BadRequest(f"missing field: {name}")
            m = _parse_int_array(payload[name], name)
            if m.shape != (e.msl,):
                raise _BadRequest(
                    f"{name} must be one measure of {e.msl} ticks; got "
                    f"shape {m.shape}"
                )
            if m.min() < 0 or m.max() >= vocab:
                raise _BadRequest(f"token values must lie in [0, {vocab})")
            pair.append(m)
        n = _get_int(payload, "num_points", 1, e.MAX_INTERP)
        with self._lock:
            out = e.interpolate(pair[0], pair[1], n)
        return {"tokens": out}

    def _arnn_inpaint(self, payload: dict) -> dict:
        """AnticipationRNN constraint-inpainting (the reference's second
        model family; serve_arnn.py). Argmax decode unless a
        ``temperature`` is given (then the reference's sampling path)."""
        e = self.arnn_engine
        if e is None:
            raise _BadRequest(
                "no AnticipationRNN model is loaded (start the server "
                "with an arnn_engine)"
            )
        tokens, single = _get_tokens(payload, e.msl, e.model.num_notes)
        m = tokens.shape[1]
        if m > e.max_measures:
            # the cap bounds the decode one request can make the engine
            # run under the serving lock (its length sets the tick count)
            raise _BadRequest(
                f"tokens have {m} measures; this engine serves at most "
                f"{e.max_measures}"
            )
        num = _get_int(payload, "num_measures", 1, m - 1)
        start = _get_int(payload, "start_measure", 1, m - num)
        seed = payload.get("seed")
        if seed is not None and not isinstance(seed, int):
            raise _BadRequest("seed must be an integer")
        temperature = payload.get("temperature")
        if temperature is not None:
            if isinstance(temperature, bool) or \
                    not isinstance(temperature, (int, float)) or \
                    not temperature > 0 or not math.isfinite(temperature):
                raise _BadRequest(
                    "temperature must be a positive finite number"
                )
            temperature = float(temperature)
        if (self._arnn_batcher is not None
                and tokens.shape[0] <= self._arnn_batcher.max_rows):
            # both decode kinds coalesce: argmax has no RNG, and sampled
            # rows draw from (seed, row-within-request)-derived keys —
            # bit-exact vs solo at a given bucket either way. The
            # batcher groups by decode kind (different programs), so a
            # sampled request only includes temperature/seed fields.
            req = {"tokens": tokens, "start_measure": start,
                   "num_measures": num}
            if temperature is not None:
                req["temperature"] = temperature
                if seed is not None:
                    req["seed"] = seed
            out = self._arnn_batcher.submit(req)
        else:
            with self._lock:
                out = e.inpaint(tokens, start, num, seed=seed,
                                temperature=temperature)
        return {"tokens": out[0] if single else out}

    def _make_handler(self, quiet: bool):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802
                if not quiet:
                    BaseHTTPRequestHandler.log_message(self, fmt, *args)

            def _reply(self, code: int, obj: dict):
                body = json.dumps(obj, default=_json_default).encode()
                self._reply_bytes(code, body, "application/json")

            def _reply_bytes(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                t0 = getattr(self, "_metrics_t0", None)
                if t0 is not None:
                    server.metrics.observe(
                        self._metrics_route, code,
                        (time.perf_counter() - t0) * 1e3,
                    )
                    self._metrics_t0 = None

            def do_GET(self):  # noqa: N802
                # GETs are metered too (the docstring advertises
                # request/status counters for every route)
                self._metrics_t0 = time.perf_counter()
                self._metrics_route = (
                    self.path if self.path in ("/healthz", "/v1/meta",
                                               "/metrics") else "_other"
                )
                if self.path == "/healthz":
                    self._reply(200, server._health())
                elif self.path == "/v1/meta":
                    self._reply(200, server._meta())
                elif self.path == "/metrics":
                    self._reply_bytes(
                        200, server.metrics.render().encode(),
                        "text/plain; version=0.0.4",
                    )
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):  # noqa: N802
                routes = {
                    "/v1/inpaint": server._inpaint,
                    "/v1/inpaint_variations": server._inpaint_variations,
                    "/v1/inpaint_ticks": server._inpaint_ticks,
                    "/v1/arnn/inpaint": server._arnn_inpaint,
                    "/v1/interpolate": server._interpolate,
                }
                path, _, query = self.path.partition("?")
                self._metrics_t0 = time.perf_counter()
                route = routes.get(path)
                # unknown paths share one label — client-chosen strings
                # must not grow the metrics cardinality unboundedly
                self._metrics_route = path if route is not None else "_other"
                if route is None:
                    self._reply(404, {"error": f"unknown path {path}"})
                    return
                ctype = (self.headers.get("Content-Type") or "")
                ctype = ctype.split(";")[0].strip().lower()
                npy = ctype == "application/x-npy"
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length <= 0 or length > _MAX_BODY:
                        raise _BadRequest("bad Content-Length")
                    body = self.rfile.read(length)
                    if npy:
                        payload = _query_payload(query)
                        try:
                            tokens = np.load(io.BytesIO(body),
                                             allow_pickle=False)
                        except (ValueError, OSError):
                            raise _BadRequest("body is not a valid .npy array")
                        if not np.issubdtype(tokens.dtype, np.integer):
                            raise _BadRequest(
                                "npy tokens must be an integer array"
                            )
                        payload["tokens"] = tokens
                    else:
                        payload = json.loads(body)
                        if not isinstance(payload, dict):
                            raise _BadRequest(
                                "request body must be a JSON object"
                            )
                    result = route(payload)
                    if npy:
                        buf = io.BytesIO()
                        np.save(buf, np.asarray(next(iter(result.values()))))
                        self._reply_bytes(200, buf.getvalue(),
                                          "application/x-npy")
                    else:
                        self._reply(200, result)
                except (_BadRequest, json.JSONDecodeError) as exc:
                    self._reply(400, {"error": str(exc)})
                except BrokenPipeError:
                    pass  # client went away mid-reply
                except Exception as exc:  # noqa: BLE001 — engine failure
                    self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

        return Handler
