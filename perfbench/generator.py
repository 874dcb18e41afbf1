"""The one traffic generator: it reads a traffic mix (``traffic/<mix>.json``)
and makes that cell's requests from the run's seed. How they are sent is
the mix's ``driver`` (``drivers/<driver>.py``), which may read keys of its
own besides these. A mix is data:

- ``rows``: tunes a request holds; ``bucket``: the engine's batch bucket
  the calls run at (warmed in set-up, and no other);
- ``measures``: a tune's length; ``spans``: ``start`` and ``num_measures``
  as [least, most], with ``past_min`` / ``future_min`` measures that must
  stay around the span. Every (start, length) pair allowed is dealt from
  one deck, shuffled by the seed, so every seed sends the same mix of
  spans, in another order;
- ``pool``: distinct token batches made in set-up and cycled (request i
  takes batch i modulo the pool);
- ``trace_requests``: requests the traced window of a ``--trace 1`` run
  holds; ``check_rows``: tunes compared with the reference after the
  window, drawn from the seed (one of the longest spans among them);
  ``keep_per_call``: tunes of each call kept for that draw.

Tokens are uniform over the vocabulary; each request has its own seed.
"""
from __future__ import annotations

import itertools

import numpy as np

KEYS = {"driver", "rows", "bucket", "measures", "spans", "pool", "trace_requests",
        "check_rows", "keep_per_call", "why"}


class Traffic:
    def __init__(self, mix: dict, cfg: dict, seed: int, extra_keys=frozenset()):
        unknown = set(mix) - KEYS - set(extra_keys)
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        self.mix = mix
        self.rows = mix["rows"]
        self.bucket = mix["bucket"]
        if self.rows > self.bucket:
            raise ValueError("a request's rows exceed its bucket")
        seq = np.random.SeedSequence(seed)
        pool_seq, deck_seq, seed_seq, keep_seq = seq.spawn(4)
        self._keep = int(keep_seq.generate_state(1)[0])
        m, msl = mix["measures"], cfg["measure_seq_len"]
        rng = np.random.default_rng(pool_seq)
        self.pool = rng.integers(0, cfg["vocab_size"], (mix["pool"], self.rows, m, msl),
                                 dtype=np.int32)
        sp = mix["spans"]
        self.deck = [(s, n) for s, n in itertools.product(
            range(sp["start"][0], sp["start"][1] + 1),
            range(sp["num_measures"][0], sp["num_measures"][1] + 1))
            if s >= sp["past_min"] and s + n <= m - sp["future_min"]]
        if not self.deck:
            raise ValueError("the spans leave no request")
        np.random.default_rng(deck_seq).shuffle(self.deck)
        self._seed_base = int(seed_seq.generate_state(2, np.uint64)[0]) >> 2

    def request(self, i: int) -> dict:
        """Request ``i`` of the run."""
        start, num = self.deck[i % len(self.deck)]
        return {"tokens": self.pool[i % len(self.pool)], "start_measure": start,
                "num_measures": num, "seed": (self._seed_base + i) % (1 << 62)}

    def call(self, k: int) -> list:
        """The requests of call ``k``: request ``k`` alone."""
        return [self.request(k)]

    def keep_rows(self, k: int) -> np.ndarray:
        """Rows of request ``k`` kept for the check."""
        want = min(self.mix["keep_per_call"], self.rows)
        rng = np.random.default_rng([self._keep, k])
        return np.sort(rng.choice(self.rows, want, replace=False))

    def check_sample(self, kept: list) -> list:
        """The kept rows compared with the reference: ``check_rows`` of
        them drawn from the seed, with one of the longest spans among
        them. ``kept`` items are dicts with ``num``."""
        rng = np.random.default_rng([self._keep, 1 << 40])
        want = min(self.mix["check_rows"], len(kept))
        pick = list(rng.choice(len(kept), want, replace=False))
        longest = max(s["num"] for s in kept)
        if not any(kept[i]["num"] == longest for i in pick):
            pick[-1] = next(i for i, s in enumerate(kept) if s["num"] == longest)
        return [kept[i] for i in sorted(pick)]
