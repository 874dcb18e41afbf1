"""The port's AnticipationRNN serving engine, its HTTP route and its tester,
on the CPU: the engine's contracts (those of ``tests/test_serve_arnn.py``),
and the engine's argmax inpaint and the tester's metrics against the JAX
package's on the same weights."""
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from inpaintnet_tpu.client import InpaintingClient
from inpaintnet_tpu.eval.anticipation_rnn_tester import AnticipationRNNTester as JaxTester
from inpaintnet_tpu.serve_arnn import ARNNServingEngine as JaxEngine
from inpaintnet_tpu_torch.eval.anticipation_rnn_tester import AnticipationRNNTester
from inpaintnet_tpu_torch.models.presets import build_flagship
from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_sampled_decode
from inpaintnet_tpu_torch.serve import InpaintingEngine, derive_row_keys
from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine
from inpaintnet_tpu_torch.server import InpaintingServer
from inpaintnet_tpu_torch.train.data import ArrayDataset

from test_torch_arnn import PortDS, V, make_pair
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def pair():
    return make_pair(16, seed=0)


@pytest.fixture(scope="module")
def engine(pair):
    # ONE bucket, so solo and coalesced requests share the padded shape
    return ARNNServingEngine(pair[1], batch_buckets=(4,), dtype="float32", device="cpu")


def _toks(b, m, seed):
    return np.random.RandomState(seed).randint(0, V, (b, m, 24)).astype(np.int32)


def test_argmax_inpaint_matches_the_jax_engine(pair, engine):
    """f32, the same weights: full-length rows with per-row spans, and a
    6-measure request that pads to the 8-measure bucket (the tick mask)."""
    jax_engine = JaxEngine(pair[0], batch_buckets=(4,), dtype="float32")
    toks = _toks(3, 8, 0)
    np.testing.assert_array_equal(engine.inpaint(toks, [3, 2, 5], [2, 4, 1]),
                                  jax_engine.inpaint(toks, [3, 2, 5], [2, 4, 1]))
    short = _toks(2, 6, 1)
    np.testing.assert_array_equal(engine.inpaint(short, 2, 3), jax_engine.inpaint(short, 2, 3))


def test_inpaint_span_only_and_deterministic(engine):
    toks = _toks(2, 8, 0)
    out = engine.inpaint(toks, start_measure=3, num_measures=2)
    assert out.shape == toks.shape and out.min() >= 0 and out.max() < V
    np.testing.assert_array_equal(out[:, :3], toks[:, :3])
    np.testing.assert_array_equal(out[:, 5:], toks[:, 5:])
    assert (out[:, 3:5] != toks[:, 3:5]).any()
    np.testing.assert_array_equal(out, engine.inpaint(toks, 3, 2, seed=123))  # argmax


def test_per_row_spans(engine):
    toks = _toks(2, 8, 1)
    het = engine.inpaint(toks, start_measure=[2, 4], num_measures=[3, 1])
    np.testing.assert_array_equal(het[0], engine.inpaint(toks[:1], 2, 3)[0])
    np.testing.assert_array_equal(het[1], engine.inpaint(toks[1:], 4, 1)[0])


def test_temperature_sampling(engine):
    toks = _toks(1, 8, 2)
    a = engine.inpaint(toks, 3, 2, seed=1, temperature=1.5)
    np.testing.assert_array_equal(a, engine.inpaint(toks, 3, 2, seed=1, temperature=1.5))
    assert not np.array_equal(a, engine.inpaint(toks, 3, 2, seed=2, temperature=1.5))
    np.testing.assert_array_equal(a[:, :3], toks[:, :3])
    # temperatures are data, not keys of what has run
    n = len(engine._compiled)
    engine.inpaint(toks, 3, 2, seed=1, temperature=0.7)
    engine.inpaint(toks, 3, 2, seed=1, temperature=2.5)
    assert len(engine._compiled) == n and (4, 8, True) in engine._compiled


def test_request_caps(engine):
    with pytest.raises(ValueError, match="max_measures"):
        engine.inpaint(_toks(1, 17, 0), 3, 2)
    bad = _toks(1, 8, 0)
    bad[0, 0, 0] = V + 5
    with pytest.raises(ValueError, match="token values"):
        engine.inpaint(bad, 3, 2)
    with pytest.raises(ValueError, match="span"):
        engine.inpaint(_toks(1, 8, 0), 0, 2)
    with pytest.raises(ValueError, match="tokens must be"):
        engine.inpaint(_toks(1, 8, 0)[:, :, :12], 3, 2)
    with pytest.raises(ValueError, match="dtype"):
        ARNNServingEngine(engine.model, dtype="int8", device="cpu")


def test_metadata_matches_the_dataset_layout(engine):
    md = engine._metadata(48).numpy()
    assert md.shape == (48, 3)  # beat marker, tick, voice id
    mds = engine.model.dataset.metadatas
    np.testing.assert_array_equal(md[:, 0], mds[0].generate(48))
    np.testing.assert_array_equal(md[:, 1], mds[1].generate(48))
    np.testing.assert_array_equal(md[:, 2], 0)


def test_oversized_batch_chunks(engine):
    toks = _toks(6, 4, 3)  # > bucket 4
    out = engine.inpaint(toks, 1, 2)
    np.testing.assert_array_equal(out[:, :1], toks[:, :1])
    np.testing.assert_array_equal(out[:4], engine.inpaint(toks[:4], 1, 2))
    np.testing.assert_array_equal(out[4:], engine.inpaint(toks[4:], 1, 2))


def test_hetero_argmax_equals_solo(engine):
    reqs = [
        {"tokens": _toks(2, 8, 20), "start_measure": 3, "num_measures": 2},
        {"tokens": _toks(1, 8, 21), "start_measure": 5, "num_measures": 1},
        # 6 measures pads to the 8-measure bucket and shares the batch
        {"tokens": _toks(1, 6, 22), "start_measure": 2, "num_measures": 1},
    ]
    for req, out in zip(reqs, engine.inpaint_hetero(reqs)):
        assert out.shape == req["tokens"].shape
        np.testing.assert_array_equal(
            out, engine.inpaint(req["tokens"], req["start_measure"], req["num_measures"]))
    with pytest.raises(ValueError, match="measure bucket"):
        engine.inpaint_hetero([reqs[0], {"tokens": _toks(1, 3, 23), "start_measure": 1,
                                         "num_measures": 1}])
    assert engine.inpaint_hetero([]) == []


def test_padded_equals_exact_length(engine):
    """A request padded to its measure bucket decodes as an unpadded run of
    the same ticks: the masked reversed constraint loop holds its zero state
    across the padded suffix."""
    m, p = engine.model, engine._params
    toks = _toks(2, 6, 30)
    total, pad_total = 6 * 24, 8 * 24
    score6 = torch.from_numpy(toks.reshape(2, total))
    score8 = torch.cat([score6, torch.zeros((2, pad_total - total), dtype=torch.int32)], dim=1)
    tick = torch.arange(pad_total)
    loc8 = ((tick < 2 * 24) | (tick >= 4 * 24)).to(torch.int32)[None].expand(2, -1)
    md8 = engine._metadata(pad_total)[None].expand(2, -1, -1)
    lg6, tok6 = m.apply_inpaint(p, score6, md8[:, :total], loc8[:, :total].contiguous())
    lg8, tok8 = m.apply_inpaint(p, score8, md8, loc8,
                                tick_mask=(tick < total).to(torch.int32)[None].expand(2, -1))
    torch.testing.assert_close(lg8[:, :total], lg6, rtol=1e-5, atol=1e-5)
    assert torch.equal(tok8[:, :total], tok6)


def test_hetero_sampled_equals_solo(engine):
    reqs = [
        {"tokens": _toks(2, 8, 50), "start_measure": 3, "num_measures": 2,
         "temperature": 1.5, "seed": 7},
        {"tokens": _toks(1, 8, 51), "start_measure": 5, "num_measures": 1,
         "temperature": 0.7, "seed": 8},
    ]
    outs = engine.inpaint_hetero(reqs, bucket=4)
    for req, out in zip(reqs, outs):
        solo = engine.inpaint(req["tokens"], req["start_measure"], req["num_measures"],
                              seed=req["seed"], temperature=req["temperature"], bucket=4)
        np.testing.assert_array_equal(out, solo)
    hot = engine.inpaint(reqs[0]["tokens"], 3, 2, seed=7, temperature=5.0, bucket=4)
    assert not np.array_equal(outs[0], hot)
    with pytest.raises(ValueError, match="decode kind"):
        engine.inpaint_hetero([reqs[0], {"tokens": _toks(1, 8, 52), "start_measure": 2,
                                         "num_measures": 1}])


def test_per_row_temperature_vector(engine):
    toks = _toks(2, 8, 53)
    keys = derive_row_keys(11, 2)
    both = engine.inpaint(toks, 3, 2, temperature=np.array([1.5, 0.7]), row_keys=keys, bucket=4)
    np.testing.assert_array_equal(
        both[0], engine.inpaint(toks[:1], 3, 2, temperature=1.5, row_keys=keys[:1], bucket=4)[0])
    np.testing.assert_array_equal(
        both[1], engine.inpaint(toks[1:], 3, 2, temperature=0.7, row_keys=keys[1:], bucket=4)[0])


def test_pin_bucket(pair):
    """A pinned bucket runs solo and coalesced requests at one shape, and a
    batch above it in chunks of it."""
    engine = ARNNServingEngine(pair[1], batch_buckets=(1, 4), dtype="float32", device="cpu")
    reqs = [{"tokens": _toks(1, 8, 40), "start_measure": 3, "num_measures": 2},
            {"tokens": _toks(2, 8, 41), "start_measure": 5, "num_measures": 1}]
    np.testing.assert_array_equal(engine.inpaint_hetero([reqs[0]], bucket=4)[0],
                                  engine.inpaint_hetero(reqs, bucket=4)[0])
    big = _toks(5, 8, 42)
    out = engine.inpaint_hetero([{"tokens": big, "start_measure": 3, "num_measures": 2}],
                                bucket=4)[0]
    np.testing.assert_array_equal(out[:1], engine.inpaint(big[:1], 3, 2, bucket=4))
    engine.warmup(8, buckets=(1,), sampled=True)
    assert {(1, 8, False), (1, 8, True)} <= set(engine._compiled)
    assert engine.length_bucket(5) == 8 and engine.measure_buckets == [4, 8, 12, 16]


# --------------------------------------------------------------------------- #
# HTTP
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def main_engine():
    model = build_flagship(vocab_size=V, hidden=16, z_dim=8, emb=6, seed=0, device="cpu")[2]
    return InpaintingEngine(model, batch_buckets=(4,), dtype="float32")


def _post(port, payload, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/arnn/inpaint", body=raw or json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_coalesces_argmax_and_sampled(engine, main_engine):
    srv = InpaintingServer(main_engine, port=0, batching=True, max_wait_ms=1000,
                           pin_bucket=4, arnn_engine=engine)
    srv.start()
    try:
        reqs = [{"tokens": _toks(1, 8, 30), "start_measure": 3, "num_measures": 2},
                {"tokens": _toks(2, 8, 31), "start_measure": 5, "num_measures": 1}]
        calls0 = srv._arnn_batcher.calls
        results = [None] * len(reqs)

        def post(i):
            r = reqs[i]
            results[i] = _post(srv.port, {**r, "tokens": r["tokens"].tolist()})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert srv._arnn_batcher.calls == calls0 + 1  # one coalesced batch
        for req, (status, out) in zip(reqs, results):
            assert status == 200, out
            np.testing.assert_array_equal(
                np.asarray(out["tokens"]),
                engine.inpaint(req["tokens"], req["start_measure"], req["num_measures"]))
        # a sampled request: its own group, equal to the engine's solo run
        stoks = _toks(1, 8, 32)
        status, out = _post(srv.port, {"tokens": stoks[0].tolist(), "start_measure": 3,
                                       "num_measures": 2, "temperature": 1.5, "seed": 4})
        assert status == 200 and srv._arnn_batcher.calls == calls0 + 2
        np.testing.assert_array_equal(np.asarray(out["tokens"]),
                                      engine.inpaint(stoks, 3, 2, seed=4, temperature=1.5,
                                                     bucket=4)[0])
    finally:
        srv.stop()
    assert arnn_sampled_decode.launches == 0  # the CPU runs the plain versions


def test_http_route(engine, main_engine):
    srv = InpaintingServer(main_engine, port=0, arnn_engine=engine)
    srv.start()
    try:
        toks = _toks(1, 8, 5)
        status, out = _post(srv.port, {"tokens": toks[0].tolist(), "start_measure": 3,
                                       "num_measures": 2})
        assert status == 200
        np.testing.assert_array_equal(np.asarray(out["tokens"]), engine.inpaint(toks, 3, 2)[0])
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/v1/meta")
        meta = json.loads(conn.getresponse().read())
        conn.close()
        assert meta["arnn"]["model"] == "AnticipationRNNBaseline"
        assert meta["arnn"]["measure_buckets"] == [4, 8, 12, 16]
        base = {"tokens": toks[0].tolist(), "start_measure": 3, "num_measures": 2}
        assert _post(srv.port, {**base, "temperature": -1})[0] == 400
        status, out = _post(srv.port, None, raw=json.dumps(base)[:-1] + ', "temperature": 1e999}')
        assert status == 400 and "finite" in out["error"]
        assert _post(srv.port, {**base, "tokens": _toks(1, 17, 0)[0].tolist()})[0] == 400
        for transport in ("npy", "json"):
            with InpaintingClient("127.0.0.1", srv.port, transport=transport) as c:
                np.testing.assert_array_equal(c.arnn_inpaint(toks, 3, 2),
                                              engine.inpaint(toks, 3, 2))
                np.testing.assert_array_equal(
                    c.arnn_inpaint(toks, 3, 2, seed=1, temperature=1.5),
                    engine.inpaint(toks, 3, 2, seed=1, temperature=1.5))
    finally:
        srv.stop()


def test_route_answers_400_without_an_engine(main_engine):
    srv = InpaintingServer(main_engine, port=0)
    srv.start()
    try:
        status, out = _post(srv.port, {"tokens": np.zeros((8, 24), int).tolist(),
                                       "start_measure": 3, "num_measures": 2})
        assert status == 400 and "AnticipationRNN" in out["error"]
    finally:
        srv.stop()


# --------------------------------------------------------------------------- #
# the tester
# --------------------------------------------------------------------------- #
class _TesterDS(PortDS):
    subdivision = 6
    num_beats_per_bar = 4

    def __init__(self, arrays):
        self.data = ArrayDataset(arrays, n_bars=12)

    def data_loaders(self, batch_size, split=(0.85, 0.10), seed=0):
        return self.data.data_loaders(batch_size, split, seed)


def test_tester_matches_the_jax_tester():
    """H 64: the port's tester runs K7's path (its plain version here), the
    JAX package's its scan; inpainting NLL and accuracy on the same batches
    (f32; the two decodes agree to about 1e-7, the metrics to 1e-5)."""
    jm, pm = make_pair(64, seed=3)
    rs = np.random.RandomState(0)
    n, total = 8, 12 * 24
    scores = rs.randint(0, V, (n, 1, total)).astype(np.int32)
    md = np.stack([PortDS.metadatas[0].generate(total), PortDS.metadatas[1].generate(total),
                   np.zeros(total, np.int64)], axis=-1)
    metadata = np.broadcast_to(md, (n, 1, total, 3)).copy()
    ds = _TesterDS((scores, metadata))
    batches = list(ds.data_loaders(batch_size=4, split=(0.01, 0.01))[2])
    assert len(batches) == 2
    tester, jax_tester = AnticipationRNNTester(ds, pm), JaxTester(ds, jm)
    loss, acc = tester.loss_and_acc_test(batches)
    loss_j, acc_j = jax_tester.loss_and_acc_test(batches)
    assert np.isfinite(loss) and abs(loss - loss_j) <= 1e-5 and abs(acc - acc_j) <= 1e-6
    loss, acc = tester.loss_and_acc_test_alt(batches)
    loss_j, acc_j = jax_tester.loss_and_acc_test_alt(batches)
    assert abs(loss - loss_j) <= 1e-5 and abs(acc - acc_j) <= 1e-6
    assert tester.test_model(batch_size=4)[0] == pytest.approx(
        tester.loss_and_acc_test(batches)[0])
    score, md_b, loc = tester.process_batch_data(batches[0])
    gen_score, gen, orig = tester.generation_from_tensor(score[:1], md_b[:1], loc[:1])
    assert gen_score is None and orig is None and gen.shape == (1, total)
    np.testing.assert_array_equal(gen[loc[:1] > 0], score[:1][loc[:1] > 0])
