"""The serving engines' CUDA-graph route (``inpaintnet_tpu_torch/graphs.py``)
and what it must leave as it was.

On the CPU (the eager route, the only one there): one engine serving a
mixed sequence of requests gives each request the tokens a fresh engine
gives it; ``graphs=True`` raises; the ``/healthz`` keys; the engine's own
copy of the weights. On the card (marked ``cuda``, skipped elsewhere) the
graph route against the eager route, bit for bit, per engine, method and
dtype; the planted faults (an operand cache built inside a capture, a host
synchronisation inside a capture); the launch counters of replays. Imports
no JAX, so the card tests run on a machine without it:

    python -m pytest tests/test_torch_serve_graphs.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.graphs import GraphCaptureError, GraphSet
from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
from inpaintnet_tpu_torch.models.presets import ARNNDataset, build_flagship
from inpaintnet_tpu_torch.ops import arnn_kernel, decode_kernel, encoder_kernel, gru_kernel
from inpaintnet_tpu_torch.ops import gru_train_kernel
from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
from inpaintnet_tpu_torch.ops.kernel_common import LAUNCH_COUNTERS
from inpaintnet_tpu_torch.serve import InpaintingEngine
from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

VOCAB = 30
N_BARS = 8
BUCKETS = (1, 4)
ARNN_BARS = 8


def _latent(hidden: int, device, auto_reg: bool = False):
    return build_flagship(vocab_size=VOCAB, hidden=hidden, z_dim=8, emb=6, seed=0,
                          device=device, auto_reg=auto_reg)[2]


def _arnn(hidden: int, device):
    return AnticipationRNNBaseline(
        ARNNDataset(VOCAB), note_embedding_dim=8, metadata_embedding_dim=4,
        num_lstm_constraints_units=hidden, num_lstm_generation_units=hidden,
        linear_hidden_size=hidden, num_layers=2, unary_constraint=True, device=device, seed=0)


def _tokens(rng, b, m, vocab=VOCAB):
    return rng.integers(0, vocab, (b, m, 24)).astype(np.int32)


def _latent_calls(auto_reg: bool):
    """A mixed sequence of engine calls (name, callable of an engine): every
    method, batches below, at and above the largest bucket, spans and
    context lengths that differ, a small request after a large one."""
    rng = np.random.default_rng(0)
    big, small, short = _tokens(rng, 6, N_BARS), _tokens(rng, 1, N_BARS), _tokens(rng, 3, 5)
    hetero = [{"tokens": _tokens(rng, 2, N_BARS), "start_measure": 2, "num_measures": 3,
               "seed": 4},
              {"tokens": _tokens(rng, 1, 6), "start_measure": 1, "num_measures": 1}]
    calls = [
        ("inpaint batch 6 (chunks of 4)", lambda e: e.inpaint(big, 3, 2, seed=7)),
        ("inpaint batch 1 after batch 6", lambda e: e.inpaint(small, 2, 4, seed=7)),
        ("inpaint batch 3, 5 measures", lambda e: e.inpaint(short, 1, 2, seed=9)),
        ("inpaint_hetero two requests", lambda e: e.inpaint_hetero(hetero)),
        ("inpaint_hetero one row", lambda e: e.inpaint_hetero(hetero[1:])),
        ("inpaint_variations batch 3", lambda e: e.inpaint_variations(short, 1, 3, 2, seed=3)),
        ("inpaint_variations batch 1", lambda e: e.inpaint_variations(small, 2, 1, 3, seed=3)),
        ("inpaint batch 1 again", lambda e: e.inpaint(small, 2, 4, seed=7)),
    ]
    if not auto_reg:
        calls += [("interpolate 5 points", lambda e: e.interpolate(big[0, 0], big[1, 1], 5)),
                  ("interpolate 1 point", lambda e: e.interpolate(small[0, 0], big[0, 2], 1))]
    return calls


def _arnn_calls():
    rng = np.random.default_rng(1)
    full, one, short = _tokens(rng, 5, ARNN_BARS), _tokens(rng, 1, ARNN_BARS), _tokens(rng, 2, 6)
    mixed = [{"tokens": _tokens(rng, 2, 7), "start_measure": 2, "num_measures": 3,
              "temperature": 1.5, "seed": 2},
             {"tokens": _tokens(rng, 1, ARNN_BARS), "start_measure": 1, "num_measures": 4,
              "temperature": 0.7}]
    return [
        ("argmax batch 5 (chunks of 4)", lambda e: e.inpaint(full, 3, 2)),
        ("argmax batch 1 after batch 5", lambda e: e.inpaint(one, 2, 4)),
        ("argmax 6 measures (tick mask)", lambda e: e.inpaint(short, 1, 3)),
        ("sampled batch 5", lambda e: e.inpaint(full, 2, 3, seed=5, temperature=1.2)),
        ("sampled 6 measures", lambda e: e.inpaint(short, 2, 2, seed=5, temperature=[0.5, 2.0])),
        ("hetero sampled, mixed lengths", lambda e: e.inpaint_hetero(mixed)),
        ("argmax batch 1 again", lambda e: e.inpaint(one, 2, 4)),
    ]


def _same(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and np.array_equal(a, b)


def _check_reuse(make_engine, calls):
    """Every call through ONE engine (its static buffers reused across
    requests) gives the tokens a fresh engine gives that call alone."""
    engine = make_engine()
    for label, call in calls:
        assert _same(call(engine), call(make_engine())), label


# --------------------------------------------------------------------------- #
# CPU
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def latent_cpu():
    return _latent(16, "cpu")


@pytest.fixture(scope="module")
def arnn_cpu():
    return _arnn(16, "cpu")


def test_engine_reuse_gives_fresh_engine_tokens(latent_cpu):
    _check_reuse(lambda: InpaintingEngine(latent_cpu, batch_buckets=BUCKETS, dtype="float32",
                                          n_bars=N_BARS, device="cpu"), _latent_calls(False))


def test_autoregressive_engine_reuse_gives_fresh_engine_tokens():
    model = _latent(16, "cpu", auto_reg=True)
    _check_reuse(lambda: InpaintingEngine(model, batch_buckets=BUCKETS, dtype="float32",
                                          n_bars=N_BARS, device="cpu"), _latent_calls(True))


def test_arnn_engine_reuse_gives_fresh_engine_tokens(arnn_cpu):
    _check_reuse(lambda: ARNNServingEngine(arnn_cpu, batch_buckets=BUCKETS, dtype="float32",
                                           max_measures=ARNN_BARS, device="cpu"), _arnn_calls())


def test_graphs_on_the_cpu_raise(latent_cpu, arnn_cpu):
    for make in (lambda g: InpaintingEngine(latent_cpu, dtype="float32", device="cpu", graphs=g),
                 lambda g: ARNNServingEngine(arnn_cpu, dtype="float32", device="cpu",
                                             graphs=g)):
        with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
            make(True)
        engine = make(None)
        assert engine.graphs is False and make(False).graphs is False
        with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
            engine.graphs = True


def test_healthz_warmed_keys_unchanged(latent_cpu, arnn_cpu):
    """The keys ``/healthz`` lists under "warmed" (the engines' ``_compiled``)
    are the methods' own, whatever the route: no GRU route, shard or
    graph in them."""
    engine = InpaintingEngine(latent_cpu, batch_buckets=BUCKETS, dtype="float32",
                              n_bars=N_BARS, device="cpu")
    engine.warmup(hetero=True)
    engine.interpolate(np.zeros(24, np.int32), np.ones(24, np.int32), 2)
    assert sorted(engine._compiled, key=str) == sorted(
        [1, 4, ("variations", 1), ("variations", 4), ("hetero", 1), ("hetero", 4), "interp"],
        key=str)
    arnn = ARNNServingEngine(arnn_cpu, batch_buckets=BUCKETS, dtype="float32",
                             max_measures=ARNN_BARS, device="cpu")
    arnn.warmup(ARNN_BARS, buckets=(1,))
    arnn.inpaint(np.zeros((2, 3, 24), np.int32), 1, 1)
    assert sorted(arnn._compiled, key=str) == sorted(
        [(1, ARNN_BARS, False), (1, ARNN_BARS, True), (4, 4, False)], key=str)


def test_model_updates_do_not_reach_the_engine():
    """The engines serve their own copy of the weights (a graph bakes in
    their addresses): an in-place update of the model after the engine is
    built leaves its tokens as they were, and reaches a new engine."""
    model, arnn = _latent(16, "cpu"), _arnn(16, "cpu")
    rng = np.random.default_rng(3)
    tokens, arnn_tokens = _tokens(rng, 2, N_BARS), _tokens(rng, 2, ARNN_BARS)
    engines = {
        "latent": (InpaintingEngine(model, batch_buckets=BUCKETS, dtype="float32",
                                    n_bars=N_BARS, device="cpu"),
                   lambda e: e.inpaint(tokens, 3, 2, seed=1),
                   lambda: InpaintingEngine(model, batch_buckets=BUCKETS, dtype="float32",
                                            n_bars=N_BARS, device="cpu")),
        "arnn": (ARNNServingEngine(arnn, batch_buckets=BUCKETS, dtype="float32",
                                   max_measures=ARNN_BARS, device="cpu"),
                 lambda e: e.inpaint(arnn_tokens, 2, 3),
                 lambda: ARNNServingEngine(arnn, batch_buckets=BUCKETS, dtype="float32",
                                           max_measures=ARNN_BARS, device="cpu")),
    }
    before = {k: call(e) for k, (e, call, _) in engines.items()}
    with torch.no_grad():
        for m in (model, arnn):
            for p in m.parameters():
                p.mul_(-1.5).add_(0.25)
    for k, (engine, call, fresh) in engines.items():
        np.testing.assert_array_equal(call(engine), before[k], err_msg=k)
        assert not np.array_equal(call(fresh()), before[k]), k


def test_every_kernel_wrapper_counts_its_launches():
    """K1-K8's wrappers register their ``launches`` counters, which the
    graph route's replays add to; on the CPU they run their plain versions
    and count nothing."""
    assert set(LAUNCH_COUNTERS) == {
        encoder_kernel.encoder_hn, encoder_kernel.encoder_hn_int8,
        decode_kernel.decode_sampling, decode_kernel.decode_sampling_int8,
        gru_kernel.gru_layer_stream, arnn_kernel.arnn_sampled_decode,
        gru_train_kernel.gru_fwd_seq, gru_train_kernel.gru_bwd_seq}
    before = [w.launches for w in LAUNCH_COUNTERS]
    InpaintingEngine(_latent(16, "cpu"), batch_buckets=(2,), dtype="float32", n_bars=N_BARS,
                     device="cpu").inpaint(_tokens(np.random.default_rng(0), 2, N_BARS), 2, 2)
    assert [w.launches for w in LAUNCH_COUNTERS] == before


# --------------------------------------------------------------------------- #
# The card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _both_routes(engine, calls, label):
    """Each call on the eager route and twice on the graph route (its
    capture, then a replay) of ONE engine: bit-equal tokens, and each
    graph replay launches each kernel as often as the eager call."""
    for name, call in calls:
        engine.graphs = False
        before = [w.launches for w in LAUNCH_COUNTERS]
        eager = call(engine)
        eager_launches = [w.launches - b for w, b in zip(LAUNCH_COUNTERS, before)]
        engine.graphs = True
        call(engine)
        before = [w.launches for w in LAUNCH_COUNTERS]
        graph = call(engine)
        graph_launches = [w.launches - b for w, b in zip(LAUNCH_COUNTERS, before)]
        assert _same(graph, eager), f"{label}: {name}"
        assert graph_launches == eager_launches, f"{label}: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [("float32", "pallas"), ("bfloat16", "xla"),
                                         ("bfloat16", "pallas"), ("int8", "xla")])
def test_graph_route_equals_eager_route(cuda, dtype, route):
    engine = InpaintingEngine(_latent(64, cuda), batch_buckets=BUCKETS, dtype=dtype,
                              n_bars=N_BARS, device=cuda)
    with gru_impl_scope(route):
        _both_routes(engine, _latent_calls(False), f"{dtype} {route}")


@pytest.mark.cuda
def test_autoregressive_graph_route_equals_eager_route(cuda):
    engine = InpaintingEngine(_latent(64, cuda, auto_reg=True), batch_buckets=BUCKETS,
                              dtype="bfloat16", n_bars=N_BARS, device=cuda)
    with gru_impl_scope("pallas"):
        _both_routes(engine, _latent_calls(True), "autoregressive")


@pytest.mark.cuda
def test_mesh_graph_route_equals_eager_route(cuda):
    from inpaintnet_tpu_torch.parallel.mesh import make_mesh

    engine = InpaintingEngine(_latent(64, cuda), batch_buckets=(2, 4), dtype="bfloat16",
                              n_bars=N_BARS, mesh=make_mesh(devices=[cuda, cuda]))
    _both_routes(engine, _latent_calls(False), "mesh")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arnn_graph_route_equals_eager_route(cuda, dtype):
    engine = ARNNServingEngine(_arnn(64, cuda), batch_buckets=BUCKETS, dtype=dtype,
                               max_measures=ARNN_BARS, device=cuda)
    _both_routes(engine, _arnn_calls(), f"arnn {dtype}")


@pytest.mark.cuda
def test_graph_engine_reuse_gives_fresh_engine_tokens(cuda):
    model, arnn = _latent(64, cuda), _arnn(64, cuda)
    _check_reuse(lambda: InpaintingEngine(model, batch_buckets=BUCKETS, dtype="bfloat16",
                                          n_bars=N_BARS, device=cuda), _latent_calls(False))
    _check_reuse(lambda: ARNNServingEngine(arnn, batch_buckets=BUCKETS, dtype="bfloat16",
                                           max_measures=ARNN_BARS, device=cuda), _arnn_calls())


@pytest.mark.cuda
def test_replays_count_launches(cuda):
    """A replay adds to each wrapper's counter the launches its capture
    counted; the capture itself adds none."""
    engine = InpaintingEngine(_latent(64, cuda), batch_buckets=(4,), dtype="bfloat16",
                              n_bars=N_BARS, device=cuda)
    tokens = _tokens(np.random.default_rng(5), 4, N_BARS)
    with gru_impl_scope("pallas"):
        engine.graphs = False
        before = [w.launches for w in LAUNCH_COUNTERS]
        engine.inpaint(tokens, 2, 2, seed=1)
        once = [w.launches - b for w, b in zip(LAUNCH_COUNTERS, before)]
        engine.graphs = True
        for calls in (1, 2, 3):  # the first runs eagerly and captures
            before = [w.launches for w in LAUNCH_COUNTERS]
            engine.inpaint(tokens, 2, 2, seed=1)
            assert [w.launches - b for w, b in zip(LAUNCH_COUNTERS, before)] == once, calls
    captured = engine._graphs[("inpaint", 4, "pallas", None)].launches
    assert {w.__name__: n for w, n in captured.items()} == {
        "encoder_hn": 1, "decode_sampling": 1, "gru_layer_stream": once[
            LAUNCH_COUNTERS.index(gru_kernel.gru_layer_stream)]}


@pytest.mark.cuda
def test_an_operand_cache_built_inside_a_capture_raises(cuda):
    """The planted fault: a decode whose weight operands are first built
    inside a capture (no eager run first) would leave them to the replay;
    ``WeightCache`` refuses, and a ``GraphSet`` capture names its key."""
    engine = InpaintingEngine(_latent(64, cuda), batch_buckets=(4,), dtype="bfloat16",
                              n_bars=N_BARS, device=cuda)
    decoder = engine.model.vae_model.decoder
    params = {k: v for k, v in engine._vae_params["decoder"].items()}
    params["head"] = {k: v.clone() for k, v in params["head"].items()}  # fresh weight tensors
    z = torch.zeros((4, 8), dtype=torch.bfloat16, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.inference_mode(), torch.cuda.graph(graph):
            decoder.decode_sampling(params, z, "none")
    # a function whose eager run reads other weights than its capture: the
    # capture is the first use of the second set
    fresh = {**params, "head": {k: v.clone() for k, v in params["head"].items()}}
    runs = iter([params, fresh])
    with pytest.raises(GraphCaptureError, match="planted-cache"):
        GraphSet().call(("planted-cache",), cuda, lambda z, *, generator=None:
                        decoder.decode_sampling(next(runs), z, "none")[1], (z,))


@pytest.mark.cuda
def test_a_host_sync_inside_a_capture_raises_with_its_key(cuda):
    graphs = GraphSet()
    x = torch.ones(8, device=cuda)

    def synced(x, *, generator=None):
        if torch.cuda.is_current_stream_capturing():
            x.sum().item()  # the planted host synchronisation
        return x * 2
    with pytest.raises(GraphCaptureError, match=r"'planted-sync', 8"):
        graphs.call(("planted-sync", 8), cuda, synced, (x,))
    assert ("planted-sync", 8) not in graphs
    # the card still serves: another key captures and replays
    out = graphs.call(("double", 8), cuda, lambda x, *, generator=None: x * 2, (x,))
    out = graphs.call(("double", 8), cuda, lambda x, *, generator=None: x * 2, (x + 1,))
    assert torch.equal(out, torch.full((8,), 4.0, device=cuda))
