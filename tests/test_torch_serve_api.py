"""The port engine's serving API beyond ``inpaint`` (``inpaint_hetero``,
``inpaint_variations``, ``interpolate``, ``inpaint_ticks``, ``warmup``) in
f32, bf16 and int8, the way ``tests/test_serve_batching.py`` checks the JAX
engine, and the port's own ``InpaintingServer`` with the JAX package's
numpy-only ``InpaintingClient`` in front of the port's engine on localhost.

hidden 64 puts every dtype on the kernel route (the plain versions on the
CPU), so int8 runs K3's and K4's numerics."""
import threading
import urllib.request

import numpy as np
import pytest
import torch

from inpaintnet_tpu.client import InpaintingClient, ServerError
from inpaintnet_tpu_torch.models import measure_vae
from inpaintnet_tpu_torch.models.presets import build_flagship
from inpaintnet_tpu_torch.serve import InpaintingEngine
from inpaintnet_tpu_torch.server import InpaintingServer

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

V = 30
DTYPES = ["float32", "bfloat16", "int8"]


@pytest.fixture(scope="module")
def model():
    return build_flagship(vocab_size=V, hidden=64, z_dim=8, emb=6, seed=0, device="cpu")[2]


@pytest.fixture(scope="module")
def engines(model):
    # ONE bucket, so solo and coalesced requests share the padded shape
    return {d: InpaintingEngine(model, batch_buckets=(8,), dtype=d) for d in DTYPES}


def _toks(b, m, seed):
    return np.random.default_rng(seed).integers(0, V, (b, m, 24)).astype(np.int32)


def _reqs():
    return [
        {"tokens": _toks(2, 16, 0), "start_measure": 8, "num_measures": 2, "seed": 5},
        {"tokens": _toks(3, 12, 1), "start_measure": 4, "num_measures": 3, "seed": 9},
        {"tokens": _toks(1, 16, 2), "start_measure": 2, "num_measures": 1},
    ]


@pytest.mark.parametrize("dtype", DTYPES)
def test_hetero_solo_equals_coalesced(engines, dtype):
    engine = engines[dtype]
    reqs = _reqs()
    coalesced = engine.inpaint_hetero(reqs)
    for req, got in zip(reqs, coalesced):
        np.testing.assert_array_equal(got, engine.inpaint_hetero([req])[0])
        s, n = req["start_measure"], req["num_measures"]
        assert got.shape == req["tokens"].shape and got.min() >= 0 and got.max() < V
        np.testing.assert_array_equal(got[:, :s], req["tokens"][:, :s])
        np.testing.assert_array_equal(got[:, s + n:], req["tokens"][:, s + n:])
    assert ("hetero", 8) in engine._compiled


@pytest.mark.parametrize("dtype", DTYPES)
def test_hetero_seeds(engines, dtype):
    engine = engines[dtype]
    reqs = _reqs()
    a = engine.inpaint_hetero(reqs)
    for x, y in zip(a, engine.inpaint_hetero(reqs)):
        np.testing.assert_array_equal(x, y)
    reqs2 = [dict(r) for r in reqs]
    reqs2[0]["seed"] = 6  # changes only that request's span
    c = engine.inpaint_hetero(reqs2)
    assert not np.array_equal(a[0], c[0])
    np.testing.assert_array_equal(a[1], c[1])
    np.testing.assert_array_equal(a[2], c[2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_hetero_rejects_oversize_and_takes_empty(engines, dtype):
    engine = engines[dtype]
    with pytest.raises(ValueError, match="rows"):
        engine.inpaint_hetero([{"tokens": _toks(9, 16, 0), "start_measure": 2,
                                "num_measures": 1}])
    with pytest.raises(ValueError, match="pinned bucket"):
        engine.inpaint_hetero(_reqs(), bucket=4)
    with pytest.raises(ValueError, match="past measure"):
        engine.inpaint_hetero([{"tokens": _toks(1, 16, 0), "start_measure": 0,
                                "num_measures": 1}])
    assert engine.inpaint_hetero([]) == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_variations_and_ticks(engines, dtype):
    engine = engines[dtype]
    tokens = _toks(3, 16, 4)
    var = engine.inpaint_variations(tokens, 6, 4, num_variations=4, seed=2)
    assert var.shape == (4, 3, 16, 24)
    for v in var:  # only the span is regenerated
        np.testing.assert_array_equal(v[:, :6], tokens[:, :6])
        np.testing.assert_array_equal(v[:, 10:], tokens[:, 10:])
    assert len({v[:, 6:10].tobytes() for v in var}) == 4
    np.testing.assert_array_equal(var, engine.inpaint_variations(tokens, 6, 4, 4, seed=2))
    row = tokens[:1].reshape(1, -1)
    np.testing.assert_array_equal(engine.inpaint_ticks(row, (24 * 6, 24 * 10), seed=3),
                                  engine.inpaint(tokens[:1], 6, 4, seed=3).reshape(1, -1))
    with pytest.raises(ValueError, match="measure-aligned"):
        engine.inpaint_ticks(row, (24 * 6 + 1, 24 * 10))


def test_variations_chunk_above_the_largest_bucket(model):
    engine = InpaintingEngine(model, batch_buckets=(2,), dtype="float32")
    tokens = _toks(3, 16, 5)
    var = engine.inpaint_variations(tokens, 6, 4, num_variations=2, seed=1)
    assert var.shape == (2, 3, 16, 24)
    from inpaintnet_tpu_torch.serve import chunk_seed

    np.testing.assert_array_equal(var[:, 2:], engine.inpaint_variations(
        tokens[2:], 6, 4, num_variations=2, seed=chunk_seed(1, 1)))


def test_int8_engine_runs_the_int8_kernels_and_warms_up(model, monkeypatch):
    """dtype="int8": bf16 masters and the K3/K4 routes (here their plain
    versions); warmup runs every method per bucket."""
    called = []
    for name in ("encoder_hn_int8", "decode_sampling_int8"):
        real = getattr(measure_vae, name)
        monkeypatch.setattr(measure_vae, name,
                            lambda *a, _n=name, _f=real: called.append(_n) or _f(*a))
    engine = InpaintingEngine(model, batch_buckets=(1, 2), dtype="int8")
    assert engine._quant == "int8"
    assert engine._params["x_0"].dtype == engine._vae_params["decoder"]["x_0"].dtype
    assert str(engine._vae_params["decoder"]["x_0"].dtype) == "torch.bfloat16"
    engine.warmup(hetero=True)
    assert set(called) == {"encoder_hn_int8", "decode_sampling_int8"}
    assert set(engine._compiled) == {1, 2, ("hetero", 1), ("hetero", 2),
                                     ("variations", 1), ("variations", 2)}


# --------------------------------------------------------------------------- #
# the HTTP front end over the port's engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["float32", "int8"])
def served(request, model):
    engine = InpaintingEngine(model, batch_buckets=(1, 8), dtype=request.param)
    engine.warmup(buckets=(8,), variations=False, hetero=True)
    server = InpaintingServer(engine, port=0, batching=True, pin_bucket=8, max_wait_ms=50)
    port = server.start()
    yield engine, port
    server.stop()


def test_server_concurrent_inpaint_equals_solo_hetero(served):
    engine, port = served
    reqs = [(_toks(1, 16 - i % 4, 10 + i), 1 + i % 5, 1 + i % 3, 100 + i) for i in range(6)]
    results, errors = [None] * len(reqs), []

    def worker(i):
        try:
            with InpaintingClient("127.0.0.1", port) as c:
                tokens, start, num, seed = reqs[i]
                results[i] = c.inpaint(tokens, start, num, seed=seed)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for (tokens, start, num, seed), got in zip(reqs, results):
        want = engine.inpaint_hetero([{"tokens": tokens, "start_measure": start,
                                       "num_measures": num, "seed": seed}], bucket=8)[0]
        np.testing.assert_array_equal(got, want)


def test_server_endpoints(served):
    engine, port = served
    tokens = _toks(2, 12, 20)
    with InpaintingClient("127.0.0.1", port) as c:
        var = c.inpaint_variations(tokens, 4, 2, num_variations=3, seed=8)
        assert var.shape == (3, 2, 12, 24)
        np.testing.assert_array_equal(var[0], c.inpaint(tokens, 4, 2, seed=8))
        row = tokens[:1].reshape(1, -1)
        ticks = c.inpaint_ticks(row, 24 * 4, 24 * 6, seed=8)
        assert ticks.shape == row.shape
        np.testing.assert_array_equal(ticks[:, :24 * 4], row[:, :24 * 4])
        interp = c.interpolate(tokens[0, 0], tokens[0, 1], 5)
        np.testing.assert_array_equal(interp, engine.interpolate(tokens[0, 0], tokens[0, 1], 5))
        health, meta = c.health(), c.meta()
        assert health["status"] == "ok" and ["hetero", 8] in health["warmed"]
        assert meta["quant"] == engine._quant and meta["max_interp_points"] == 62
        assert meta["vocab_size"] == V and meta["max_target"] == engine.max_target
        with pytest.raises(ServerError) as bad:
            c.inpaint(tokens, 0, 2)  # no past measure
        assert bad.value.status == 400
        with pytest.raises(ServerError) as bad:
            c.interpolate(tokens[0, 0], tokens[0, 1], engine.MAX_INTERP + 1)
        assert bad.value.status == 400


def test_server_metrics_time_the_batch_wait(model):
    """Two requests coalesced into one batch: ``GET /metrics`` counts one
    batch of two and each request's wait in the batcher's queue."""
    engine = InpaintingEngine(model, batch_buckets=(2,), dtype="float32")
    # a batch of two rows dispatches as soon as the second arrives
    server = InpaintingServer(engine, port=0, batching=True, max_wait_ms=10_000)
    port = server.start()
    errors = []

    def worker(i):
        try:
            with InpaintingClient("127.0.0.1", port) as c:
                c.inpaint(_toks(1, 16, 30 + i), 4, 2, seed=i)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            lines = r.read().decode().splitlines()
    finally:
        server.stop()
    values = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in lines
              if ln.startswith("inpaintnet_")}
    assert values["inpaintnet_coalesced_batch_size_count"] == 1
    assert values["inpaintnet_coalesced_batch_size_sum"] == 2
    assert values["inpaintnet_batch_wait_ms_count"] == 2
    assert values['inpaintnet_batch_wait_ms_bucket{le="+Inf"}'] == 2
    assert 0 < values["inpaintnet_batch_wait_ms_sum"] < 10_000
    assert "# TYPE inpaintnet_batch_wait_ms histogram" in lines
