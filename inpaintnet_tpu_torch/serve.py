"""Batched inpainting serving engine (``inpaintnet_tpu/serve.py``).

Requests are padded into a static (bucket, n_bars, 24) layout: past and
future contexts in ``n_bars`` buffers with validity masks, the target span
in ``max_target`` rows, batch padded up to the smallest bucket that fits.
Batches above the largest bucket run in bucket-size chunks.

    engine = InpaintingEngine(latent_rnn_model, dtype="int8", device="cuda")
    out = engine.inpaint(tokens_b_m_24, start_measure=8, num_measures=2)
    outs = engine.inpaint_hetero([{"tokens": t, "start_measure": 8,
                                   "num_measures": 2, "seed": 7}, ...])

``inpaintnet_tpu_torch.server.InpaintingServer`` (numpy only) serves this
engine over HTTP: it reads ``_quant``, ``MAX_INTERP``, ``_compiled`` and
the model geometry named there.

The model may be autoregressive (``auto_reg``): it then splits the
engine's per-row keys and generator draws itself, and
``inpaint_variations`` runs full passes instead of redrawing cached
posteriors. The GRU route (``ops/gru.py``'s ``"xla"`` or ``"pallas"``) is
the caller's: ``gru_impl_scope`` around a call, or ``INPAINTNET_GRU_IMPL``.

With ``mesh=`` (a local ``parallel.mesh`` mesh, the JAX package's
``shard_map`` path) every bucket must divide the mesh's data axis; the
weights are copied whole to each data index's device (a (data, model) mesh
replicates them, as the JAX package's engine does: its model axis idles),
each shard's rows run on its device (shards on one device in turn), and the
outputs come back in row order.
Per-row keys travel with their rows, so ``inpaint_hetero`` is row for row
the engine without a mesh; the batch-seed paths (``inpaint``,
``inpaint_variations``) fold the shard index into the seed
(``parallel.mesh.fold_seed``), as the JAX package folds the data index
into the key.

On the card each fixed-shape call runs as a captured CUDA graph
(``graphs.py``), the counterpart of the JAX engine's one compiled program
per bucket: one graph per (method, bucket, GRU route, shard), where the
methods are ``inpaint`` (batch seed), ``inpaint_hetero`` (per-row keys),
``inpaint_variations``' encode and generate (JAX's ``enc_dists`` /
``gen_dists``) and ``interpolate`` (JAX's ``interp``, one graph a route).
A key's first call runs eagerly and captures it; later calls replay it,
with the tokens of the eager route bit for bit (the same function, the
batch seed's generator registered with the graph and seeded as the eager
route seeds its own). ``graphs=False`` keeps the eager route on the card;
the CPU has only that route. The engine holds its own copy of the weights
(a graph bakes in their addresses), and a lock from copy-in to copy-out
(the graphs' static buffers are shared by every call of a key).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from inpaintnet_tpu_torch.graphs import GraphRouted
from inpaintnet_tpu_torch.models.base import cast_params
from inpaintnet_tpu_torch.ops.gru import get_gru_impl
from inpaintnet_tpu_torch.parallel.mesh import Mesh, batch_sharding, fold_seed, replicate
from inpaintnet_tpu_torch.utils.profiling import count, span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SERVE_DTYPES = (*DTYPES, "int8")

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def pick_bucket(buckets: Sequence[int], rows: int) -> int:
    """Smallest bucket that fits ``rows`` (largest one otherwise)."""
    return next((b for b in buckets if b >= rows), buckets[-1])


def token_wire_dtype(vocab: int):
    """The compact dtype of token arrays on the wire (int16 whenever the
    vocabulary allows; the caller has validated values in [0, vocab))."""
    return np.int16 if vocab < 2**15 else np.int32


def chunk_seed(seed: int, index: int) -> int:
    """Seed of chunk ``index`` of a request split at the largest bucket (and
    of variation ``index`` of ``inpaint_variations``): a hash of (seed,
    index), so it does not collide with another request's plain seed the
    way ``seed + index`` would."""
    state = np.random.SeedSequence(entropy=seed, spawn_key=(index,)).generate_state(2)
    return int(state[0]) << 32 | int(state[1])


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (full-avalanche 64-bit hash)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return x ^ (x >> np.uint64(31))


def derive_row_keys(seed: int, n: int) -> np.ndarray:
    """Per-row keys of :meth:`InpaintingEngine.inpaint_hetero`: a double
    splitmix64 hash of (request seed, row index) -> (n, 2) uint32. Depends
    only on (seed, row within the request): the coalescing contract. The
    same keys as the JAX package's ``serve.derive_row_keys``."""
    with np.errstate(over="ignore"):
        s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
        base = _splitmix64(np.full(n, s, np.uint64))
        j = np.arange(n, dtype=np.uint64)
        h = _splitmix64(base ^ ((j * np.uint64(0xD2B74407B1CE6E93) + np.uint64(1)) & _M64))
    return np.stack([(h >> np.uint64(32)).astype(np.uint32),
                     (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)


class InpaintingEngine(GraphRouted):
    # max interpolation points per request: rows pad to one (64, z) decode
    # (the decode is row-independent, so the padding is exact)
    MAX_INTERP = 62

    def __init__(self, model, batch_buckets: Sequence[int] = (1, 8, 64, 512),
                 dtype: str = "bfloat16", n_bars: int = 16, device=None, seed: int = 0,
                 mesh: Optional[Mesh] = None, graphs: Optional[bool] = None):
        """:param model: a ``LatentRNN`` (its parameters are copied, in
            ``dtype``, to ``device``: a later update of the model does not
            reach the engine)
        :param dtype: serving numeric, "float32", "bfloat16", or "int8"
            (bf16 master parameters and the int8 kernels K3/K4)
        :param device: where the engine runs; defaults to the model's device
            (with a mesh: the mesh's first device)
        :param mesh: optional local mesh: requests are sharded over its
            "data" axis, the weights copied to each data index's device;
            every bucket must divide the data axis
        :param graphs: replay each fixed-shape call as a CUDA graph
            (default: on a CUDA device); False keeps the eager route, and
            True off the card raises ValueError
        """
        if dtype not in SERVE_DTYPES:
            raise ValueError(f"dtype must be one of {sorted(SERVE_DTYPES)}, got {dtype!r}")
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("the engine shards over a local mesh (make_mesh(devices=...)), "
                                 "not a process group's world")
            dp = mesh.shape["data"]
            bad = [bk for bk in sorted(batch_buckets) if bk % dp]
            if bad:
                raise ValueError(
                    f"batch buckets {bad} do not divide the mesh 'data' axis ({dp}); "
                    "shard_map requires every bucket to split evenly across data-parallel "
                    "devices")
            device = mesh.devices[0]
        self.mesh = mesh
        self._quant = "int8" if dtype == "int8" else "none"
        param_dtype = DTYPES["bfloat16" if dtype == "int8" else dtype]
        self.model = model
        self.n_bars = n_bars
        self.max_target = model.max_target
        self.msl = model.measure_seq_len
        self.vocab = model.vae_model.num_notes
        self.batch_buckets = sorted(batch_buckets)
        self.seed = seed
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self._init_graphs(graphs)
        with torch.inference_mode(False):
            self._params = cast_params(model.params(), self.device, param_dtype, copy=True)
            self._vae_params = cast_params(model.vae_model.params(), self.device, param_dtype,
                                           copy=True)
            # the weights of each shard, on its device (one copy a device)
            self._replicas = ([(self._params, self._vae_params)] if mesh is None else
                              replicate(mesh, (self._params, self._vae_params)))
        # the (method, bucket) keys each serving method has run, for the HTTP
        # server's /healthz; a dict, which list() copies atomically
        self._compiled: Dict[object, bool] = {}

    def warmup(self, buckets: Optional[Sequence[int]] = None, variations: bool = True,
               hetero: bool = False) -> None:
        """Run a dummy 1-measure request per bucket (default: all) through
        ``inpaint``, ``inpaint_variations`` (unless ``variations=False``,
        or the model is autoregressive: its variations are ``inpaint`` and
        ``inpaint_hetero`` calls) and ``inpaint_hetero`` (with
        ``hetero=True``), so the first real request pays neither the kernel
        build nor first-call set-up: on the graph route, each captures its
        keys under the GRU route in force."""
        for bucket in (buckets if buckets is not None else self.batch_buckets):
            tokens = np.zeros((bucket, self.n_bars, self.msl), np.int32)
            self.inpaint(tokens, start_measure=1, num_measures=1, seed=0)
            if variations and not self.model.auto_reg:
                self.inpaint_variations(tokens, start_measure=1, num_measures=1,
                                        num_variations=1, seed=0)
            if hetero:
                self.inpaint_hetero([{"tokens": tokens, "start_measure": 1,
                                      "num_measures": 1, "seed": 0}])

    def _validate_request(self, tokens: np.ndarray, start_measure: int, num_measures: int):
        """-> (b, m, n_past, n_future); raises ValueError on a bad request."""
        if tokens.ndim != 3 or tokens.shape[2] != self.msl:
            raise ValueError(f"tokens must be (B, M, {self.msl}), got {tokens.shape}")
        b, m, _ = tokens.shape
        if not 1 <= num_measures <= self.max_target:
            raise ValueError(f"num_measures must lie in [1, {self.max_target}]")
        if not (0 < start_measure and start_measure + num_measures < m + 1):
            raise ValueError("the span must leave at least one past measure and fit in M")
        if m > self.n_bars:
            raise ValueError(f"at most {self.n_bars} measures, got {m}")
        if not np.issubdtype(tokens.dtype, np.integer):
            raise ValueError(f"tokens must be integers, got {tokens.dtype}")
        if tokens.size and (tokens.min() < 0 or tokens.max() >= self.vocab):
            raise ValueError(f"token values must lie in [0, {self.vocab})")
        return b, m, start_measure, m - start_measure - num_measures

    def _pack_request(self, tokens: np.ndarray, start_measure: int, num_measures: int,
                      bucket: int):
        """Validate and pad a request into the static (bucket, n_bars, msl)
        layout: int32 tokens, float32 masks. An all-zero future mask means
        no future context."""
        b, m, n_past, n_future = self._validate_request(tokens, start_measure, num_measures)
        if b > bucket:
            raise ValueError(f"batch {b} exceeds bucket {bucket}")
        arrays = self._empty_batch(bucket)
        self._fill_rows(arrays, slice(0, b), tokens, num_measures, m, n_past, n_future)
        return arrays

    def _empty_batch(self, bucket: int):
        nb, msl = self.n_bars, self.msl
        return (np.zeros((bucket, nb, msl), np.int32), np.zeros((bucket, nb), np.float32),
                np.zeros((bucket, nb, msl), np.int32), np.zeros((bucket, nb), np.float32),
                np.zeros((bucket, self.max_target), np.float32))

    @staticmethod
    def _fill_rows(arrays, rows: slice, tokens, num_measures: int, m: int, n_past: int,
                   n_future: int) -> None:
        past, pm, future, fm, tm = arrays
        past[rows, :n_past] = tokens[:, :n_past]
        if n_future:
            future[rows, :n_future] = tokens[:, m - n_future:]
        pm[rows, :n_past] = 1
        fm[rows, :n_future] = 1
        tm[rows, :num_measures] = 1

    @staticmethod
    def _count_needed(arrays) -> None:
        """Count the encoder rows and decoder rows a batch's requests need
        (``encoder.rows_needed``, ``decoder.rows_needed``) from its host
        masks: the present context measures and the target measures. Pad
        rows' masks are zero."""
        _, pm, _, fm, tm = arrays
        count("encoder.rows_needed", int(pm.sum() + fm.sum()))
        count("decoder.rows_needed", int(tm.sum()))

    def _shards(self, arrays):
        """(shard index, its rows of the host ``arrays`` as tensors, the
        device, its weights) of a batch: one shard on the engine's device
        without a mesh (index None), else one a data index, which takes rows
        [i n / D, (i + 1) n / D) (``parallel.mesh.shard_batch``'s split:
        every bucket divides the data axis)."""
        arrays = tuple(torch.from_numpy(a) for a in arrays)
        if self.mesh is None:
            return [(None, arrays, self.device, self._replicas[0])]
        devices = batch_sharding(self.mesh).devices()
        per = arrays[0].shape[0] // len(devices)
        return [(i, tuple(a[i * per:(i + 1) * per] for a in arrays), d, w)
                for i, (d, w) in enumerate(zip(devices, self._replicas))]

    def _sample_fn(self, params, vae_params) -> Callable:
        """``(past, pm, future, fm, tm[, row_keys], generator=) -> samples``
        of one shard: the model's inference pass, its draws from per-row
        keys where the call gives them, else from the generator."""
        def sample(past, pm, future, fm, tm, row_keys=None, *, generator=None):
            draw = {"row_keys": row_keys} if row_keys is not None else {"generator": generator}
            return self.model.apply(params, vae_params, past, future, None, past_mask=pm,
                                    future_mask=fm, target_mask=tm, quant=self._quant,
                                    **draw)[1]
        return sample

    def _run(self, arrays, bucket: int, seed: Optional[int] = None,
             row_keys: Optional[np.ndarray] = None) -> np.ndarray:
        """One padded batch through the model -> (bucket, max_target, msl)
        samples on the host, each shard on its device (the graph key
        ``("inpaint" | "hetero", bucket, GRU route, shard)``). The draws: a
        batch ``seed`` (a generator; a shard's folds in its index), or
        per-row ``row_keys`` (B, 2), which shard with their rows."""
        outs = []
        keys = () if row_keys is None else (row_keys,)
        method, route = ("inpaint" if row_keys is None else "hetero"), get_gru_impl()
        with self._graphs.lock:
            for i, shard, device, (params, vae_params) in self._shards(tuple(arrays) + keys):
                samples = self._call((method, bucket, route, i), device,
                                     self._sample_fn(params, vae_params), shard,
                                     None if row_keys is not None else self._shard_seed(seed, i))
                with span("engine.copy_out", device):
                    outs.append(samples.cpu().numpy())
        return np.concatenate(outs)

    @staticmethod
    def _shard_seed(seed: int, shard: Optional[int]) -> int:
        """The generator seed of a batch seed (of shard ``shard`` of a
        mesh: the seed folded with its index)."""
        return seed if shard is None else fold_seed(seed, shard)

    def _resolve_seed(self, seed: Optional[int]) -> int:
        seed = self.seed if seed is None else seed
        if seed < 0:
            raise ValueError("seed must be non-negative")
        return seed

    def inpaint(self, tokens: np.ndarray, start_measure: int, num_measures: int,
                seed: Optional[int] = None) -> np.ndarray:
        """Inpaint ``num_measures`` measures starting at ``start_measure``.

        :param tokens: (B, M, msl) int tokens, M <= n_bars; batches larger
            than the biggest bucket run in bucket-size chunks
        :param start_measure: first measure (0-based) of the masked span
        :param num_measures: 1..max_target measures to regenerate
        :param seed: rsample seed (default: the engine's); the same seed and
            request give the same tokens
        :return: (B, M, msl) tokens with the span replaced
        """
        tokens = np.asarray(tokens)
        seed = self._resolve_seed(seed)
        b = tokens.shape[0]
        largest = self.batch_buckets[-1]
        if b > largest:
            return np.concatenate([
                self.inpaint(tokens[lo:lo + largest], start_measure, num_measures,
                             seed=chunk_seed(seed, i))
                for i, lo in enumerate(range(0, b, largest))
            ])
        with span("engine.call"):
            with span("engine.validate"):
                _, m, n_past, n_future = self._validate_request(tokens, start_measure,
                                                                num_measures)
                bucket = pick_bucket(self.batch_buckets, b)
            with span("engine.pack"):
                arrays = self._empty_batch(bucket)
                self._fill_rows(arrays, slice(0, b), tokens, num_measures, m, n_past, n_future)
                self._count_needed(arrays)
            samples = self._run(arrays, bucket, seed=seed)
            self._compiled[bucket] = True
            with span("engine.scatter"):
                out = tokens.copy()
                out[:, start_measure:start_measure + num_measures] = samples[:b, :num_measures]
            return out

    def inpaint_hetero(self, requests: Sequence[dict], bucket: Optional[int] = None) -> list:
        """One device batch serving several independent requests with
        (possibly) different spans: the dynamic-batching primitive behind
        ``inpaintnet_tpu_torch.server.InpaintingServer``'s request coalescing.

        Each row draws its noise from a key derived from (its request's
        seed, its row within the request) (:func:`derive_row_keys`), and
        every kernel computes each row from that row's inputs alone (int8
        included: K4's hidden bound is per row), so a request gets the SAME
        tokens whether it runs solo or coalesced with others, at a given
        bucket.

        :param requests: dicts with ``tokens`` (b, M, msl),
            ``start_measure``, ``num_measures`` and an optional ``seed``
            (default: the engine's)
        :param bucket: run at this bucket instead of the smallest that fits
            (the server's ``pin_bucket``)
        :return: one (b, M, msl) output per request, only its span replaced
        """
        if not requests:
            return []
        with span("engine.call"):
            with span("engine.validate"):
                norm, rows = [], 0
                for r in requests:
                    tokens = np.asarray(r["tokens"])
                    start, num = r["start_measure"], r["num_measures"]
                    b, m, n_past, n_future = self._validate_request(tokens, start, num)
                    seed = self.seed if r.get("seed") is None else r["seed"]
                    norm.append((tokens, start, num, seed, b, m, n_past, n_future))
                    rows += b
                cap = self.batch_buckets[-1] if bucket is None else bucket
                if rows > cap:
                    raise ValueError(
                        f"{rows} total rows exceed the "
                        f"{'largest bucket' if bucket is None else 'pinned bucket'} ({cap}); "
                        "split the request set")
                if bucket is None:
                    bucket = pick_bucket(self.batch_buckets, rows)
            with span("engine.pack"):
                arrays = self._empty_batch(bucket)
                row_keys = np.zeros((bucket, 2), np.int64)
                lo = 0
                for tokens, start, num, seed, b, m, n_past, n_future in norm:
                    self._fill_rows(arrays, slice(lo, lo + b), tokens, num, m, n_past, n_future)
                    row_keys[lo:lo + b] = derive_row_keys(seed, b)
                    lo += b
                self._count_needed(arrays)
            samples = self._run(arrays, bucket, row_keys=row_keys)
            self._compiled[("hetero", bucket)] = True
            with span("engine.scatter"):
                outs, lo = [], 0
                for tokens, start, num, seed, b, m, n_past, n_future in norm:
                    out = tokens.copy()
                    out[:, start:start + num] = samples[lo:lo + b, :num]
                    outs.append(out)
                    lo += b
            return outs

    def inpaint_variations(self, tokens: np.ndarray, start_measure: int, num_measures: int,
                           num_variations: int, seed: Optional[int] = None) -> np.ndarray:
        """``num_variations`` stochastic re-inpaintings of the SAME context,
        with the frozen encoder run ONCE: the variations differ only in the
        context rsample, so the cached posteriors are drawn again for each.
        Variation ``i`` draws from seed ``chunk_seed(seed, i)``.

        An autoregressive model re-encodes its own samples, so no cached
        posterior serves it (``inpaintnet_tpu/serve.py:481-503``): when the
        tiled rows fit the largest bucket, the variations are ONE
        ``inpaint_hetero`` call of the request tiled ``num_variations``
        times (per-row keys make every tiled row its own draw); otherwise
        variation ``i`` is a full ``inpaint`` with seed ``chunk_seed(seed, i)``.

        :return: (num_variations, B, M, msl) tokens
        """
        tokens = np.asarray(tokens)
        seed = self._resolve_seed(seed)
        if num_variations < 1:
            raise ValueError("num_variations must be at least 1")
        b = tokens.shape[0]
        largest = self.batch_buckets[-1]
        if self.model.auto_reg:
            if num_variations * b <= largest:
                out = self.inpaint_hetero([{
                    "tokens": np.tile(tokens, (num_variations, 1, 1)),
                    "start_measure": start_measure, "num_measures": num_measures,
                    "seed": seed}])[0]
                return out.reshape((num_variations, b) + out.shape[1:])
            return np.stack([self.inpaint(tokens, start_measure, num_measures,
                                          seed=chunk_seed(seed, i))
                             for i in range(num_variations)])
        if b > largest:
            return np.concatenate([
                self.inpaint_variations(tokens[lo:lo + largest], start_measure, num_measures,
                                        num_variations, seed=chunk_seed(seed, i))
                for i, lo in enumerate(range(0, b, largest))
            ], axis=1)
        bucket = pick_bucket(self.batch_buckets, b)
        arrays = self._pack_request(tokens, start_measure, num_measures, bucket)
        samples = [[] for _ in range(num_variations)]
        model, quant, route = self.model, self._quant, get_gru_impl()
        with self._graphs.lock:
            for shard, (past, pm, future, fm, tm), device, (params, vae_params) in self._shards(
                    arrays):
                def enc_dists(past, future, *, generator=None, vae_params=vae_params):
                    (pl, ps), (fl, fs) = model.encode_context_dists(vae_params, past, future,
                                                                    quant)
                    return pl, ps, fl, fs

                def gen_dists(pl, ps, fl, fs, pm, fm, tm, *, generator=None, params=params,
                              vae_params=vae_params):
                    return model.generate_from_context_dists(
                        params, vae_params, (pl, ps), (fl, fs), past_mask=pm, future_mask=fm,
                        target_mask=tm, generator=generator, quant=quant)[1]

                dists = self._call(("enc_dists", bucket, route, shard), device, enc_dists,
                                   (past, future))
                for i in range(num_variations):
                    s = self._call(("gen_dists", bucket, route, shard), device, gen_dists,
                                   (*dists, pm, fm, tm),
                                   self._shard_seed(chunk_seed(seed, i), shard))
                    samples[i].append(s.cpu().numpy())
        outs = []
        for i in range(num_variations):
            out = tokens.copy()
            out[:, start_measure:start_measure + num_measures] = (
                np.concatenate(samples[i])[:b, :num_measures])
            outs.append(out)
        self._compiled[("variations", bucket)] = True
        return np.stack(outs)

    def interpolate(self, measure_a: np.ndarray, measure_b: np.ndarray,
                    num_points: int) -> np.ndarray:
        """Latent interpolation between two measures: encode both to their
        posterior MEANS, decode ``num_points`` evenly spaced interpolants
        plus both endpoints with the frozen VAE (argmax: deterministic).

        :param measure_a/measure_b: (msl,) int tokens
        :return: (num_points + 2, msl) int32 tokens, a -> b
        """
        if not 1 <= num_points <= self.MAX_INTERP:
            raise ValueError(f"num_points must lie in [1, {self.MAX_INTERP}]")
        pair = np.stack([np.asarray(measure_a).reshape(self.msl),
                         np.asarray(measure_b).reshape(self.msl)])
        if not np.issubdtype(pair.dtype, np.integer) or pair.min() < 0 \
                or pair.max() >= self.vocab:
            raise ValueError(f"measures must be integer tokens in [0, {self.vocab})")
        n = num_points + 2
        # pad to one fixed row count; the pad rows decode and are sliced away
        alphas = np.zeros((self.MAX_INTERP + 2,), np.float32)
        alphas[:n] = np.arange(n, dtype=np.float32) / (n - 1)
        vae, vae_params, quant = self.model.vae_model, self._vae_params, self._quant

        def interp(pair, alphas, *, generator=None):
            dist = vae.encoder.apply(vae_params["encoder"], pair, quant)
            a = alphas[:, None]
            z1, z2 = dist.loc[0].float(), dist.loc[1].float()
            # mixed in f32 as the JAX package's promotion does, then fed to
            # the decoder in the parameter dtype
            zs = (z1[None, :] * (1 - a) + z2[None, :] * a).to(dist.loc.dtype)
            return vae.decoder.decode_sampling(vae_params["decoder"], zs, quant)[1]

        with self._graphs.lock:
            out = self._call(("interp", get_gru_impl()), self.device, interp,
                             (torch.from_numpy(pair.astype(np.int32)),
                              torch.from_numpy(alphas))).cpu().numpy()
        self._compiled["interp"] = True
        return out[:n].astype(np.int32)

    def inpaint_ticks(self, tensor_score: np.ndarray, time_index_range_ticks: Tuple[int, int],
                      seed: Optional[int] = None) -> np.ndarray:
        """Tick-range form of :meth:`inpaint`: (1, L) tokens and a
        measure-aligned [a, b) tick range -> (1, L) tokens."""
        a, b = time_index_range_ticks
        if a % self.msl or b % self.msl:
            raise ValueError(f"the tick range must be measure-aligned (multiples of {self.msl})")
        tokens = np.asarray(tensor_score).reshape(1, -1, self.msl)
        out = self.inpaint(tokens, a // self.msl, (b - a) // self.msl, seed=seed)
        return out.reshape(1, -1)
