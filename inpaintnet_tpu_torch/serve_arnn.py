"""Batched serving engine of the AnticipationRNN family
(``inpaintnet_tpu/serve_arnn.py``).

The model inpaints by constraint masking: ticks outside the span are
forced to the ground truth and the span decodes autoregressively, by argmax
(``apply_inpaint``: K7 on the card) or by temperature sampling
(``generate``). The engine:

- synthesizes the metadata channels (beat marker, tick, voice id) from the
  model's dataset ``metadatas`` by position, once per sequence length, and
  keeps them on the device: clients send tokens only;
- pads sequences to MEASURE BUCKETS with a per-row tick mask: the
  constraint LSTM runs backwards, meets a row's padded suffix first and
  holds its zero state there, so a padded row decodes exactly as its
  unpadded self (``ops/lstm.py``); requests of different lengths within a
  bucket share a batch;
- pads rows to BATCH BUCKETS and runs batches above the largest (or the
  pinned) bucket in bucket-size chunks;
- gives every sampled row its own key, derived from (request seed, row in
  the request) by ``serve.derive_row_keys``, and per-row Gumbel noise from
  it (``ops/sampling.row_gumbel``), and takes temperatures as a (B,)
  vector, so a request's tokens are the same solo or coalesced with others
  (``inpaint_hetero``, the server's batching primitive) at a given bucket.

    engine = ARNNServingEngine(arnn_model, dtype="bfloat16", device="cuda")
    out = engine.inpaint(tokens_b_m_24, start_measure=8, num_measures=2)

``inpaintnet_tpu_torch.server.InpaintingServer(..., arnn_engine=engine)``
serves it at ``POST /v1/arnn/inpaint``; it reads ``batch_buckets``,
``max_measures``, ``measure_buckets``, ``msl`` and ``model.num_notes``, and
calls ``length_bucket``, ``inpaint`` and ``inpaint_hetero``. ``_compiled``
records the (row bucket, measure bucket, sampled) keys run so far.

On the card each call runs as a captured CUDA graph (``graphs.py``), the
counterpart of the JAX engine's one compiled program per (row bucket,
measure bucket, decode kind): one graph per (row bucket, measure bucket,
argmax or sampled, tick mask present or not), the last the host's choice
of whether any row is shorter than its bucket. The per-row spans, lengths,
temperatures and keys are its static inputs, so the graph route gives the
eager route's tokens bit for bit. ``graphs=False`` keeps the eager route
on the card; the CPU has only that route. The engine holds its own copy of
the weights and a lock from copy-in to copy-out.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from inpaintnet_tpu_torch.graphs import GraphRouted
from inpaintnet_tpu_torch.models.base import cast_params
from inpaintnet_tpu_torch.serve import DTYPES, derive_row_keys, pick_bucket
from inpaintnet_tpu_torch.utils.profiling import span

__all__ = ["ARNNServingEngine"]


class ARNNServingEngine(GraphRouted):
    def __init__(self, model, batch_buckets: Sequence[int] = (1, 8, 64, 512),
                 dtype: str = "bfloat16", measure_seq_len: int = 24, max_measures: int = 16,
                 seed: int = 0, measure_buckets: Optional[Sequence[int]] = None, device=None,
                 graphs: Optional[bool] = None):
        """:param model: an ``AnticipationRNNBaseline`` or
            ``ConstraintModelGaussianReg`` (its ``dataset`` gives the
            metadata channels; its parameters are copied, in ``dtype``, to
            ``device``: a later update of the model does not reach the
            engine)
        :param dtype: serving numeric, "float32" or "bfloat16"
        :param max_measures: cap on a request's length in measures: it
            bounds the decode a request can make the engine run
        :param measure_buckets: sequence lengths requests pad to; default
            {4, 8, 12} below ``max_measures``, plus ``max_measures``
        :param device: where the engine runs; defaults to the model's device
        :param graphs: replay each call as a CUDA graph (default: on a
            CUDA device); False keeps the eager route, and True off the
            card raises ValueError
        """
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        if measure_buckets is None:
            measure_buckets = {m for m in (4, 8, 12) if m < max_measures} | {max_measures}
        if max(measure_buckets) != max_measures:
            raise ValueError("the largest measure bucket must equal max_measures")
        self.model = model
        self.msl = measure_seq_len
        self.max_measures = max_measures
        self.measure_buckets = sorted(measure_buckets)
        self.batch_buckets = sorted(batch_buckets)
        self.seed = seed
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self._init_graphs(graphs)
        with torch.inference_mode(False):
            self._params = cast_params(model.params(), self.device, DTYPES[dtype], copy=True)
        # the (row bucket, measure bucket, sampled) keys run so far; a dict,
        # which list() copies atomically
        self._compiled: Dict[object, bool] = {}
        self._md_cache: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------------ #
    def _metadata(self, total_ticks: int) -> torch.Tensor:
        """(T, num_md) int32 metadata channels by position (the dataset's
        ``metadatas`` and a zero voice id), on the device, made once per
        length: they are the same for every row."""
        if total_ticks not in self._md_cache:
            channels = [md.generate(total_ticks) for md in self.model.dataset.metadatas]
            channels.append(np.zeros((total_ticks,), np.int64))
            self._md_cache[total_ticks] = torch.from_numpy(
                np.stack(channels, axis=1).astype(np.int32)).to(self.device)
        return self._md_cache[total_ticks]

    def length_bucket(self, measures: int) -> int:
        """Smallest measure bucket that fits ``measures`` (requests pad to
        it; the server's batcher groups by it)."""
        if measures > self.max_measures:
            raise ValueError(f"{measures} measures exceed max_measures={self.max_measures}")
        return pick_bucket(self.measure_buckets, measures)

    def warmup(self, measures: int, buckets: Optional[Sequence[int]] = None,
               sampled: bool = True) -> None:
        """Run a dummy request per row bucket (default: all) at the measure
        bucket ``measures`` pads to, argmax and (unless ``sampled=False``)
        sampled, so the first real request pays neither the kernel build nor
        first-call set-up (on the graph route: each captures its key, with
        no tick mask)."""
        for bucket in (buckets if buckets is not None else self.batch_buckets):
            tokens = np.zeros((bucket, measures, self.msl), np.int32)
            self.inpaint(tokens, start_measure=1, num_measures=1)
            if sampled:
                self.inpaint(tokens, start_measure=1, num_measures=1, seed=0, temperature=1.0)

    # ------------------------------------------------------------------ #
    def _run(self, score: np.ndarray, starts: np.ndarray, nums: np.ndarray,
             lengths: np.ndarray, row_keys: Optional[np.ndarray],
             temps: Optional[np.ndarray]) -> np.ndarray:
        """One padded (bucket, T) batch through the model -> (bucket, T)
        int32 tokens on the host. The constraint mask and the tick mask
        are built on the device from the per-row (start, num, length) in
        measures; the tick mask is left out when every row is full length
        (it would hold nothing)."""
        dev, msl, model, params = self.device, self.msl, self.model, self._params
        b, total = score.shape
        sampled = temps is not None
        masked = not (lengths * msl == total).all()
        md = self._metadata(total)[None].expand(b, -1, -1)

        def decode(score_t, starts_t, nums_t, lens_t, *sampling, generator=None):
            tick = torch.arange(total, device=dev)[None, :]
            loc = ((tick < starts_t * msl) | (tick >= (starts_t + nums_t) * msl)).to(torch.int32)
            tick_mask = (tick < lens_t * msl).to(torch.int32) if masked else None
            if not sampled:
                return model.apply_inpaint(params, score_t, md, loc, tick_mask=tick_mask)[1]
            temps_t, keys_t = sampling
            return model.generate(params, score_t, md, loc, temperature=temps_t, row_keys=keys_t,
                                  tick_mask=tick_mask)[1]

        inputs = (torch.from_numpy(score.astype(np.int32)),
                  *(torch.from_numpy(a.astype(np.int64))[:, None] for a in (starts, nums, lengths)))
        if sampled:
            inputs += (torch.from_numpy(temps), torch.from_numpy(row_keys.astype(np.int64)))
        with self._graphs.lock:
            gen = self._call((b, total // msl, sampled, masked), dev, decode, inputs)
            with span("engine.copy_out", dev):
                return gen.cpu().numpy()

    def inpaint_hetero(self, requests: Sequence[dict], bucket: Optional[int] = None) -> list:
        """Several independent requests in ONE batch (the dynamic-batching
        primitive of the HTTP server). Constraint masks, tick masks,
        temperatures and sampling keys are all per row, so each request's
        tokens equal its solo run's at a given (row bucket, measure bucket):
        pin ``bucket`` for bit-identity across load levels. Requests may
        differ in length within one measure bucket (the shorter ones are
        suffix-padded); they must share a decode kind (all argmax or all
        sampled).

        :param requests: dicts with ``tokens`` (b, M, msl), ``start_measure``,
            ``num_measures``, and optional ``temperature`` and ``seed``
            (sampled: row keys derive from (seed, row within the request))
        :return: one (b, M, msl) output per request
        """
        if not requests:
            return []
        with span("engine.call"):
            with span("engine.validate"):
                ms = [np.asarray(r["tokens"]).shape[1] for r in requests]
                mbs = {self.length_bucket(m) for m in ms}
                if len(mbs) != 1:
                    raise ValueError(
                        f"coalesced ARNN requests must share a measure bucket "
                        f"({self.measure_buckets}); got lengths {sorted(set(ms))} spanning "
                        f"buckets {sorted(mbs)}")
                mb = mbs.pop()
                kinds = {r.get("temperature") is None for r in requests}
                if len(kinds) != 1:
                    raise ValueError("coalesced ARNN requests must share a decode kind "
                                     "(all argmax or all sampled)")
            with span("engine.pack"):
                toks = [np.asarray(r["tokens"]) for r in requests]
                toks = [t if t.shape[1] == mb else np.concatenate(
                    [t, np.zeros((t.shape[0], mb - t.shape[1], t.shape[2]), t.dtype)], axis=1)
                    for t in toks]
                sizes = [t.shape[0] for t in toks]

                def per_row(values, dtype):
                    return np.concatenate([np.full((n,), v, dtype)
                                           for n, v in zip(sizes, values)])

                sampled = not kinds.pop()
                temperature = row_keys = None
                if sampled:
                    temperature = per_row([r["temperature"] for r in requests], np.float32)
                    row_keys = np.concatenate([
                        derive_row_keys(self.seed if r.get("seed") is None else r["seed"], n)
                        for n, r in zip(sizes, requests)])
                starts = per_row([r["start_measure"] for r in requests], np.int64)
                nums = per_row([r["num_measures"] for r in requests], np.int64)
                tokens, lengths = np.concatenate(toks), per_row(ms, np.int64)
            out = self._inpaint(tokens, starts, nums, temperature=temperature, bucket=bucket,
                                row_keys=row_keys, lengths=lengths)
            with span("engine.scatter"):
                outs, lo = [], 0
                for n, m in zip(sizes, ms):
                    outs.append(out[lo:lo + n, :m])
                    lo += n
            return outs

    def inpaint(self, tokens: np.ndarray, start_measure, num_measures,
                seed: Optional[int] = None, temperature=None, bucket: Optional[int] = None,
                row_keys: Optional[np.ndarray] = None,
                lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """Regenerate ``num_measures`` measures from ``start_measure``.

        :param tokens: (B, M, msl) int tokens, M <= ``max_measures``; M pads
            to its measure bucket (exactly, by the tick mask) and the
            response keeps the input's M
        :param start_measure/num_measures: ints, or per-row sequences
        :param temperature: None = argmax (deterministic; ``seed`` unused);
            a float or a (B,) vector = temperature sampling, row ``b``
            drawing from the key ``derive_row_keys(seed, B)[b]``
        :param bucket: run at this row bucket instead of the smallest that
            fits (the server's ``pin_bucket``); larger batches run in chunks
            of it
        :param row_keys: optional (B, 2) uint32 per-row keys (the hetero
            path's), in place of ``seed``'s
        :param lengths: optional (B,) true lengths in measures of rows that
            the hetero path already suffix-padded to M (spans inside them)
        :return: (B, M, msl) tokens with each row's span replaced
        """
        with span("engine.call"):
            return self._inpaint(tokens, start_measure, num_measures, seed, temperature,
                                 bucket, row_keys, lengths)

    def _inpaint(self, tokens, start_measure, num_measures, seed=None, temperature=None,
                 bucket=None, row_keys=None, lengths=None) -> np.ndarray:
        """:meth:`inpaint` inside its ``engine.call`` span (a batch above
        the bucket runs its chunks in the same call)."""
        with span("engine.validate"):
            tokens = np.asarray(tokens)
            if tokens.ndim != 3 or tokens.shape[2] != self.msl:
                raise ValueError(f"tokens must be (B, M, {self.msl}), got {tokens.shape}")
            b, m, msl = tokens.shape
            if m > self.max_measures:
                raise ValueError(f"{m} measures exceed max_measures={self.max_measures} (the "
                                 "cap bounds the decode a request can ask for)")
            vocab = self.model.num_notes
            if not np.issubdtype(tokens.dtype, np.integer) or (
                    tokens.size and (tokens.min() < 0 or tokens.max() >= vocab)):
                raise ValueError(f"token values must be integers in [0, {vocab})")
            lens = np.broadcast_to(np.asarray(m if lengths is None else lengths, np.int64), (b,))
            starts = np.broadcast_to(np.asarray(start_measure, np.int64), (b,))
            nums = np.broadcast_to(np.asarray(num_measures, np.int64), (b,))
            if not ((lens <= m) & (lens >= 1) & (nums >= 1) & (starts >= 1)
                    & (starts + nums <= lens)).all():
                raise ValueError("need >= 1 past measure, >= 1 span measure, and the span "
                                 "inside the row's length")
            sampled = temperature is not None
            if sampled and row_keys is None:
                # the keys a lone request gets in inpaint_hetero: solo == coalesced
                row_keys = derive_row_keys(self.seed if seed is None else seed, b)
            temps = None
            if sampled:
                temps = np.broadcast_to(np.asarray(temperature, np.float32), (b,))
        cap = self.batch_buckets[-1] if bucket is None else bucket
        if b > cap:
            return np.concatenate([
                self._inpaint(tokens[lo:lo + cap], starts[lo:lo + cap], nums[lo:lo + cap],
                              temperature=None if temps is None else temps[lo:lo + cap],
                              bucket=bucket,
                              row_keys=None if row_keys is None else row_keys[lo:lo + cap],
                              lengths=lens[lo:lo + cap])
                for lo in range(0, b, cap)])
        with span("engine.pack"):
            mb = self.length_bucket(m)
            if bucket is None:
                bucket = pick_bucket(self.batch_buckets, b)
            total = mb * msl
            # pad rows run full length with a 1-measure span; their tokens are dropped
            score = np.zeros((bucket, total), np.int32)
            score[:b, :m * msl] = tokens.reshape(b, m * msl)
            starts_w, nums_w, lens_w = (np.ones((bucket,), np.int64),
                                        np.ones((bucket,), np.int64),
                                        np.full((bucket,), mb, np.int64))
            starts_w[:b], nums_w[:b], lens_w[:b] = starts, nums, lens
            keys_w = temps_w = None
            if sampled:
                keys_w = np.zeros((bucket, 2), np.int64)
                keys_w[:b] = row_keys
                temps_w = np.ones((bucket,), np.float32)
                temps_w[:b] = temps
        gen = self._run(score, starts_w, nums_w, lens_w, keys_w, temps_w)
        self._compiled[(bucket, mb, sampled)] = True
        with span("engine.scatter"):
            # the span scatter on the host, from the host's copy of the spans
            tick = np.arange(m * msl)
            in_span = ((tick[None, :] >= (starts * msl)[:, None])
                       & (tick[None, :] < ((starts + nums) * msl)[:, None]))
            out = tokens.reshape(b, m * msl).copy()
            out[in_span] = gen[:b, :m * msl][in_span]
            return out.reshape(b, m, msl)
