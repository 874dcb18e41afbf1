"""Batched inpainting serving engine (``inpaintnet_tpu/serve.py``).

Requests are padded into a static (bucket, n_bars, 24) layout: past and
future contexts in ``n_bars`` buffers with validity masks, the target span
in ``max_target`` rows, batch padded up to the smallest bucket that fits.
Batches above the largest bucket run in bucket-size chunks.

    engine = InpaintingEngine(latent_rnn_model, device="cuda")
    out = engine.inpaint(tokens_b_m_24, start_measure=8, num_measures=2)

Not ported yet (ROADMAP queue 1 items 6-7): ``inpaint_hetero``,
``inpaint_variations``, ``interpolate``, ``inpaint_ticks``, ``dtype="int8"``
and CUDA-graph buckets.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from inpaintnet_tpu_torch.models.base import cast_params

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pick_bucket(buckets: Sequence[int], rows: int) -> int:
    """Smallest bucket that fits ``rows`` (largest one otherwise)."""
    return next((b for b in buckets if b >= rows), buckets[-1])


def chunk_seed(seed: int, index: int) -> int:
    """Seed of chunk ``index`` of a request split at the largest bucket: a
    hash of (seed, index), so it does not collide with another request's
    plain seed the way ``seed + index`` would."""
    state = np.random.SeedSequence(entropy=seed, spawn_key=(index,)).generate_state(2)
    return int(state[0]) << 32 | int(state[1])


class InpaintingEngine:
    def __init__(self, model, batch_buckets: Sequence[int] = (1, 8, 64, 512),
                 dtype: str = "bfloat16", n_bars: int = 16, device=None, seed: int = 0):
        """:param model: a ``LatentRNN`` (its parameters are copied, in
            ``dtype``, to ``device``)
        :param dtype: serving numeric, "float32" or "bfloat16"
        :param device: where the engine runs; defaults to the model's device
        """
        if dtype == "int8":
            raise NotImplementedError("int8 serving is not ported yet (ROADMAP queue 1 item 7)")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        self.model = model
        self.n_bars = n_bars
        self.max_target = model.max_target
        self.msl = model.measure_seq_len
        self.vocab = model.vae_model.num_notes
        self.batch_buckets = sorted(batch_buckets)
        self.seed = seed
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self._params = cast_params(model.params(), self.device, DTYPES[dtype])
        self._vae_params = cast_params(model.vae_model.params(), self.device, DTYPES[dtype])

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run a dummy 1-measure request per bucket (default: all), so the
        first real request pays neither the kernel build nor first-call
        set-up."""
        for bucket in (buckets if buckets is not None else self.batch_buckets):
            tokens = np.zeros((bucket, self.n_bars, self.msl), np.int32)
            self.inpaint(tokens, start_measure=1, num_measures=1, seed=0)

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
        nb, msl = self.n_bars, self.msl
        past = np.zeros((bucket, nb, msl), np.int32)
        future = np.zeros((bucket, nb, msl), np.int32)
        past[:b, :n_past] = tokens[:, :n_past]
        if n_future:
            future[:b, :n_future] = tokens[:, m - n_future:]
        pm = np.zeros((bucket, nb), np.float32)
        fm = np.zeros((bucket, nb), np.float32)
        tm = np.zeros((bucket, self.max_target), np.float32)
        pm[:, :n_past] = 1
        fm[:, :n_future] = 1
        tm[:, :num_measures] = 1
        return past, pm, future, fm, tm

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
        seed = self.seed if seed is None else seed
        if seed < 0:
            raise ValueError("seed must be non-negative")
        b = tokens.shape[0]
        largest = self.batch_buckets[-1]
        if b > largest:
            return np.concatenate([
                self.inpaint(tokens[lo:lo + largest], start_measure, num_measures,
                             seed=chunk_seed(seed, i))
                for i, lo in enumerate(range(0, b, largest))
            ])
        bucket = pick_bucket(self.batch_buckets, b)
        arrays = self._pack_request(tokens, start_measure, num_measures, bucket)
        past, pm, future, fm, tm = (torch.from_numpy(a).to(self.device) for a in arrays)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            _, samples, _ = self.model.apply(
                self._params, self._vae_params, past, future, None,
                past_mask=pm, future_mask=fm, target_mask=tm, generator=generator)
            samples = samples.cpu().numpy()
        out = tokens.copy()
        out[:, start_measure:start_measure + num_measures] = samples[:b, :num_measures]
        return out
