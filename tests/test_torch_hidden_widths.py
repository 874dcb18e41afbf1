"""Every hidden width the JAX package's kernels take, on the port's kernel
routes: a width that is not whole 64-unit blocks (or, for K8, K5 and K6 in
bf16 above 512, an odd number of them) runs at the next width the plans
take, on zero units (``kernel_common.pad_units``).

- K8 on the ``"pallas"`` route at H 100 and at bf16 H 576 and 704, where
  the wrapper used to raise on the card: the route decision here, the
  kernel on the card;
- the port's gates against the JAX package's (opened as on a TPU) at every
  H from 8 to 1024 in steps of 8, both dtypes, K5/K6 and K8 also from 1024
  to 4096 in steps of 64 and around the tile groups' ceilings, and K7's at
  contexts up to 19,083 and generation widths up to 640: wherever JAX's
  gate takes a geometry, the port's does (``LEFT_FOR_LATER`` is empty);
- each plain version on the wrapper's padded operands, sliced back, against
  the plain version at H: float64 within 1e-12 (K3's int8 carries and K4
  bit-equal), and the gate-major layout (``kernel_common.gate_padding``)
  rejected;
- the JAX package's kernels at H 16 (interpret mode) against the port's
  kernel routes there (their plain versions on the CPU), K1, K2 and K7;
- the trainfast Function at H 100 and 1024 against the eager loop.

JAX is imported inside the tests that compare with it, so the card's tests
run on a machine without it:

    python -m pytest tests/test_torch_hidden_widths.py -m cuda -q --noconftest
"""
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import arnn_kernel, decode_kernel, encoder_kernel
from inpaintnet_tpu_torch.ops import gru as gru_mod
from inpaintnet_tpu_torch.ops import gru_kernel as lk
from inpaintnet_tpu_torch.ops import gru_train_kernel as tk
from inpaintnet_tpu_torch.ops import kernel_common as kc
from inpaintnet_tpu_torch.ops.gru import gru_init
from inpaintnet_tpu_torch.ops.gru_trainfast import gru_layer_trainfast
from inpaintnet_tpu_torch.ops.linear import embedding_init

from test_torch_cuda_kernels import (  # noqa: F401  (cuda: the card's fixture)
    _arnn_case,
    _decode_case,
    _gru_layer_case,
    _train_case,
    _tree,
    cuda,
)

EXACT = 1e-12  # float64: the zero units add exact zeros; only the sums' blocking differs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other test modules run (their
    fixture lives in a module that imports JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# K8 on the "pallas" route at the widths its wrapper refused on the card
# --------------------------------------------------------------------------- #
K8_WIDTHS = [(100, torch.float32, 128), (100, torch.bfloat16, 128),
             (576, torch.bfloat16, 640), (704, torch.bfloat16, 768),
             (576, torch.float32, 576)]  # f32: 9 CTAs of 64 units, a non-portable cluster


@pytest.mark.parametrize("hidden,dtype,padded", K8_WIDTHS)
def test_pallas_route_takes_k8_at_every_width(monkeypatch, hidden, dtype, padded):
    """The route decision: ``gru_layer_apply(impl="pallas")`` calls K8's
    wrapper, which runs the layer at ``padded`` units (a width its plans
    take) and slices it back; on the CPU the wrapper's plain version."""
    assert kc.gru_layer_supports_hidden(hidden, dtype)
    assert kc.gru_layer_width(hidden, dtype) == padded
    rng = np.random.default_rng(hidden)
    p = _tree(gru_init(rng, 8, hidden, 1)[0][0], "cpu", dtype, rng)
    x = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32)).to(dtype)
    h0 = torch.from_numpy(0.5 * rng.standard_normal((3, hidden)).astype(np.float32)).to(dtype)
    xw = x @ p["w_ih"] + p["b_ih"]
    ops = lk.padded_operands(xw, p["w_hh"], p["b_hh"], h0)
    assert [tuple(t.shape) for t in ops] == [(3, 4, 3 * padded), (padded, 3 * padded),
                                            (3 * padded,), (3, padded)]
    calls, real = [], gru_mod.gru_layer_stream
    monkeypatch.setattr(gru_mod, "gru_layer_stream",
                        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    ys, hn = gru_mod.gru_layer_apply(p, x, h0, impl="pallas")
    assert calls == [(hidden, 3 * hidden)]
    want = lk.gru_layer_reference(xw, p["w_hh"], p["b_hh"], h0)
    assert torch.equal(ys, want[0]) and torch.equal(hn, want[1])


def test_pallas_route_past_1024_runs_the_eager_loop(monkeypatch):
    """A layer wider than 1024 no longer runs the eager loop on
    ``"pallas"``: since K8 runs on tile groups it takes every width, so H
    1030 calls K8's wrapper (at 1088, on zero units), whose plain version
    here is the layer's function; the eager loop runs no step."""
    rng = np.random.default_rng(0)
    p = _tree(gru_init(rng, 4, 1030, 1)[0][0], "cpu", torch.float32, rng)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    h0 = torch.from_numpy(0.5 * rng.standard_normal((2, 1030)).astype(np.float32))
    assert kc.gru_layer_supports_hidden(1030, torch.float32)
    assert kc.gru_layer_width(1030, torch.float32) == 1088
    calls, real = [], gru_mod.gru_layer_stream
    monkeypatch.setattr(gru_mod, "gru_layer_stream",
                        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    monkeypatch.setattr(gru_mod, "_eager_layer", None)  # any eager step would raise
    got = gru_mod.gru_layer_apply(p, x, h0, impl="pallas")
    assert calls == [(1030, 3 * 1030)]
    want = lk.gru_layer_reference(x @ p["w_ih"] + p["b_ih"], p["w_hh"], p["b_hh"], h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype,padded", K8_WIDTHS)
def test_pallas_route_runs_k8_on_card(cuda, hidden, dtype, padded):
    """On the card, ``gru_layer_apply(impl="pallas")`` launches K8 at these
    widths (at ``padded`` units) within ``gru_kernel.BOUNDS`` of the plain
    version at H, suffix masks with an all-zero row and want_ys both ways."""
    rng = np.random.default_rng(hidden)
    p = _tree(gru_init(rng, 16, hidden, 1)[0][0], cuda, dtype, rng)
    x = torch.from_numpy(rng.standard_normal((70, 6, 16)).astype(np.float32)).to(cuda, dtype)
    h0 = torch.from_numpy(0.5 * rng.standard_normal((70, hidden)).astype(np.float32)).to(cuda,
                                                                                         dtype)
    mask = _gru_layer_case(rng, 70, 6, 64, torch.float32, cuda, "suffix")[4]
    xw = x @ p["w_ih"] + p["b_ih"]
    for want_ys in (True, False):
        before = lk.gru_layer_stream.launches
        got = gru_mod.gru_layer_apply(p, x, h0, mask=mask, want_ys=want_ys, impl="pallas")
        want = lk.gru_layer_reference(xw, p["w_hh"], p["b_hh"], h0, mask, want_ys=want_ys)
        torch.cuda.synchronize()
        assert lk.gru_layer_stream.launches == before + 1
        agree = lk.agreement(got, want)
        assert lk.within(agree, lk.BOUNDS[dtype]), (hidden, dtype, want_ys, agree)


# --------------------------------------------------------------------------- #
# The port's gates against the JAX package's, at every width
# --------------------------------------------------------------------------- #
class LeftForLater(NamedTuple):
    """The widths at which the JAX package's gates take a kernel and the
    port's do not yet: none is left."""
    k7: range  # none: every H (bf16 to 640) and every C (JAX: bf16 C <= 19,083 at H 64)
    k8: range  # none: K5/K6 and K8 run above 1024 on tile groups (JAX: no width gate)


LEFT_FOR_LATER = LeftForLater(range(0), range(0))
GATE_WIDTHS = range(8, 1025, 8)
# K5/K6 and K8 above 1024: tile groups to 4096, and around the widest group
# an H100 holds (132 CTAs of 64 units in f32: 8448; of 128: 16896), past
# which one launch a step runs
WIDE_GATE_WIDTHS = [*range(1088, 4097, 64), *(c + d for c in (8448, 16896) for d in (-64, 0, 64))]
# K7's widest geometries of the JAX gate at V 60 and linear 256 (H, C): bf16
# H = C 541, C 19,083 at H 64 and 3,954 at H 256, H 619 at C 16 and 612 at
# C 64; f32 H = C 377, C 1,513 at H 256, H 430 at C 16
K7_GATE_EDGES = ((541, 541), (64, 19083), (256, 3954), (619, 16), (612, 64), (582, 256),
                 (545, 512), (377, 377), (256, 1513), (430, 16), (422, 64), (64, 9317))
K7_CONTEXTS = range(8, 19084, 8)  # beside H 64 and 256
K7_HIDDEN = range(8, 641, 8)  # beside C 16 and 64


@pytest.fixture
def on_tpu(monkeypatch):
    """JAX's gates as on a TPU (its kernels' default implementations)."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for name in ("INPAINTNET_ENCODER_IMPL", "INPAINTNET_DECODE_IMPL", "INPAINTNET_ARNN_IMPL"):
        monkeypatch.delenv(name, raising=False)


def _agree(jax_takes: bool, port_takes: bool, left: bool, geometry) -> int:
    """Where JAX's gate takes a geometry, the port's does exactly when the
    geometry is not left for later. -> 1 if JAX took it."""
    if jax_takes:
        assert port_takes == (not left), geometry
    return int(jax_takes)


def test_port_gates_take_what_the_jax_gates_take(on_tpu):
    import jax.numpy as jnp

    from inpaintnet_tpu.models.anticipation_rnn import ConstraintModelGaussianReg as JaxCMGR
    from inpaintnet_tpu.models.measure_vae import Encoder as JaxEncoder
    from inpaintnet_tpu.models.measure_vae import HierarchicalDecoder as JaxHD
    from inpaintnet_tpu_torch.models.anticipation_rnn import ConstraintModelGaussianReg
    from inpaintnet_tpu_torch.models.measure_vae import Encoder, HierarchicalDecoder

    taken = dict.fromkeys(("k1", "k2", "k7", "k5_k8"), 0)
    left = LEFT_FOR_LATER
    for dtype_j, dtype_t in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        w = jnp.zeros((1, 1), dtype_j)
        bf16 = dtype_t == torch.bfloat16
        for hidden in GATE_WIDTHS:
            port_self = SimpleNamespace(num_layers=2, rnn_hidden_size=hidden)
            jax_enc = SimpleNamespace(bidirectional=True, num_layers=2, rnn_hidden_size=hidden)
            taken["k1"] += _agree(JaxEncoder._use_pallas(jax_enc, {"gru": [None, [{"w_hh": w}]]}),
                                  Encoder.use_kernel(port_self, dtype_t), False,
                                  ("K1/K3", hidden, dtype_t))
            for vocab in (30, 60, 128, 256):
                jax_dec = SimpleNamespace(num_layers=2, sampling="argmax", rnn_hidden_size=hidden,
                                          num_notes=vocab)
                port_takes = (HierarchicalDecoder.use_kernel(port_self, dtype_t)
                              and decode_kernel.decode_supports(hidden, dtype_t)
                              and decode_kernel.decode_supports(hidden, "int8", dtype_t))
                taken["k2"] += _agree(
                    JaxHD._use_pallas_decode(jax_dec, {"tick_gru": [[{"w_hh": w}]]}), port_takes,
                    False, ("K2/K4", hidden, vocab, dtype_t))
        # K5/K6 and K8: the JAX package's routes have no width gate
        for hidden in (*GATE_WIDTHS, *WIDE_GATE_WIDTHS):
            taken["k5_k8"] += _agree(True, tk.trainfast_supports(hidden)
                                     and kc.gru_layer_supports_hidden(hidden, dtype_t),
                                     hidden in left.k8, ("K5/K6/K8", hidden, dtype_t))
        pairs = ([(h, h) for h in GATE_WIDTHS] + [(h, 256) for h in GATE_WIDTHS]
                 + [(h, c) for h in (64, 256) for c in K7_CONTEXTS]
                 + [(h, c) for c in (16, 64) for h in K7_HIDDEN] + list(K7_GATE_EDGES))
        for hidden, ctx in pairs:
            for linear, vocab in ((64, 60), (256, 60), (256, 256)):
                dims = dict(num_layers=2, num_lstm_generation_units=hidden,
                            num_lstm_constraints_units=ctx, num_units_linear=linear,
                            num_notes=vocab)
                jax_takes = JaxCMGR._use_pallas_decode(
                    SimpleNamespace(**dims),
                    {"lstm_generation": [{"w_hh": w}],
                     "note_embedding": {"table": np.zeros((vocab + 1, 1))}})
                port_takes = ConstraintModelGaussianReg._use_kernel_decode(
                    SimpleNamespace(**dims),
                    {"lstm_generation": [{"w_hh": torch.zeros(1, dtype=dtype_t)}]})
                taken["k7"] += _agree(jax_takes, port_takes,
                                      hidden in left.k7 or ctx in left.k7,
                                      ("K7", hidden, ctx, linear, vocab, dtype_t))
    # the grid is not vacuous: each JAX gate takes much of it
    assert min(taken.values()) >= 100, taken


# --------------------------------------------------------------------------- #
# The plain versions on the wrappers' padded operands, sliced back
# --------------------------------------------------------------------------- #
@pytest.fixture
def float64_plain(monkeypatch):
    """The plain versions take ``.float()`` as their f32 upcast: here it
    keeps float64 (and upcasts anything else to f32, as always), so the
    same code runs every product and gate in float64 and the zero units'
    exactness shows to 1e-12, not behind f32's rounding of sums whose
    blocking the padding moves."""
    real = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda self, *a, **k: self if self.dtype == torch.float64
                        else real(self, *a, **k))


def _close(got, want, tol=EXACT) -> float:
    err = max((g.double() - w.double()).abs().max().item() for g, w in zip(got, want))
    assert err <= tol, err
    return err


@pytest.mark.parametrize("hidden,padded,mask_kind,reverse", [
    (16, None, "suffix", False), (100, None, "interior", True), (576, 640, "target", False),
    (704, 768, None, True)])
def test_plain_k8_on_zero_units_is_the_narrow_layer(float64_plain, hidden, padded, mask_kind,
                                                    reverse):
    """K8's plain version on ``padded_operands`` (bf16's widths, 640 and
    768, named: float64 takes the f32 route's rule) sliced back: the plain
    version at H; the padded units' outputs exactly 0."""
    xw, w, b, h0, mask = _gru_layer_case(np.random.default_rng(hidden), 5, 7, hidden,
                                         torch.float64, "cpu", mask_kind)
    want = lk.gru_layer_reference(xw, w, b, h0, mask, reverse=reverse)
    ops = lk.padded_operands(xw, w, b, h0, padded)
    width = ops[1].shape[0]
    assert width == (padded or kc.round_up(hidden, 64))
    ys, hn = lk.gru_layer_reference(*ops, mask, reverse=reverse)
    assert not ys[..., hidden:].any() and not hn[..., hidden:].any()
    _close([kc.unpad_units(ys, hidden, width), kc.unpad_units(hn, hidden, width)], want)


@pytest.mark.parametrize("hidden,padded", [(16, None), (100, None), (576, 640), (1000, None)])
def test_plain_k5_k6_on_zero_units_are_the_narrow_layer(float64_plain, hidden, padded):
    """K5's plain version on ``fwd_padded_operands`` and K6's on what the
    trainfast Function hands it (W_hh with zero units, K5's residuals at
    the padded width, dys and hprev with zero units), sliced back: the
    plain versions at H. K5's padded units emit r = z = 1/2 and n = hn = 0;
    K6's padded da, dhw and dh0 are exactly 0 (zero dys, zero rows and
    columns of W_hh)."""
    fwd, dys, hprev = _train_case(np.random.default_rng(hidden), 4, hidden, 3, torch.float64,
                                  "cpu")
    width = padded or kc.round_up(hidden, 64)
    for reverse in (False, True):
        want = tk.gru_fwd_seq_reference(*fwd, reverse=reverse)
        got = tk.gru_fwd_seq_reference(*tk.fwd_padded_operands(*fwd, padded), reverse=reverse)
        assert got[0].shape[-1] == width
        pad = [o[..., hidden:] for o in got]
        assert not pad[0].any() and (pad[1] == 0.5).all() and (pad[2] == 0.5).all()
        assert not pad[3].any() and not pad[4].any()
        _close([kc.unpad_units(o, hidden, width) for o in got], want)
        want = tk.gru_bwd_seq_reference(fwd[0], dys, *want[1:], hprev, reverse=reverse)
        da, dhw, dh0 = tk.gru_bwd_seq_reference(
            tk.fwd_padded_operands(*fwd, padded)[0], kc.pad_units(dys, hidden, width),
            *got[1:], kc.pad_units(hprev, hidden, width), reverse=reverse)
        for t in (da, dhw):
            assert not t.unflatten(-1, (3, width))[..., hidden:].any()
        assert not dh0[..., hidden:].any()
        _close([kc.unpad_units(da, hidden, width, 3), kc.unpad_units(dhw, hidden, width, 3),
                kc.unpad_units(dh0, hidden, width)], want)


def _encoder_case(hidden: int, dtype, seed: int = 0, batch: int = 5):
    rng = np.random.default_rng(seed)
    gru = _tree(gru_init(rng, 10, hidden, 2, True), "cpu", dtype, rng)
    table = _tree(embedding_init(rng, 30, 10)["table"], "cpu", dtype, rng)
    tokens = torch.from_numpy(rng.integers(0, 30, (batch, 24)).astype(np.int32))
    keep = torch.from_numpy(rng.random((batch, 24, 2 * hidden)) >= 0.3)
    return gru, table, tokens, keep


@pytest.mark.parametrize("hidden", [16, 100])
def test_plain_k1_k3_on_zero_units_are_the_narrow_encoder(float64_plain, hidden):
    """K1's plain versions (inference, the training mode's keep mask, the
    staged route in chunks) on ``encoder_padded_operands``, h_n sliced back:
    the plain versions at H. K3's: its int8 carries bit-equal (a zero
    column quantizes to 0 at its floored scale, a padded h to 0), and so
    its bf16 h_n; the unquantized last state it returns in a wider master
    within 1e-12 in float64 (PyTorch's CPU tanh may round a row of 16 and
    one of 64 apart in the last bit; the card computes each element alike)."""
    gru, table, tokens, keep = _encoder_case(hidden, torch.float64)
    width = kc.round_up(hidden, 64)
    params, keep_p = encoder_kernel.encoder_padded_operands(gru, keep)
    assert keep_p.shape == (5, 24, 2 * width) and params[1][0]["w_ih"].shape == (2 * width,
                                                                                3 * width)
    for run in (lambda g, k: encoder_kernel.encoder_hn_reference(g, table, tokens),
                lambda g, k: encoder_kernel.encoder_hn_reference(g, table, tokens, k, 0.3),
                lambda g, k: encoder_kernel.encoder_hn_staged_reference(g, table, tokens, k, 0.3,
                                                                        max_chunk_rows=2)):
        got = run(params, keep_p)
        assert not got[..., hidden:].any()
        _close([kc.unpad_units(got, hidden, width)], [run(gru, keep)])
    for dtype in (torch.float64, torch.bfloat16):
        gru, table, tokens, _ = _encoder_case(hidden, dtype, seed=1)
        got, got_ys = encoder_kernel.encoder_int8_layers_reference(
            encoder_kernel.encoder_padded_operands(gru)[0], table, tokens)
        want, want_ys = encoder_kernel.encoder_int8_layers_reference(gru, table, tokens)
        assert torch.equal(kc.unpad_units(got_ys, hidden, width), want_ys)
        if dtype == torch.bfloat16:
            assert torch.equal(kc.unpad_units(got, hidden, width), want)
        else:
            _close([kc.unpad_units(got, hidden, width)], [want])


@pytest.mark.parametrize("hidden", [16, 100])
def test_plain_k2_k4_on_zero_units_are_the_narrow_decoder(float64_plain, hidden):
    """K2's plain version on ``decode_padded_operands``: the narrow
    decoder's logits (within 1e-12) and samples (equal); K4's bit-equal on
    bf16 and f32 masters (its per-row bound and column scales see only
    zeros more)."""
    args = _decode_case(np.random.default_rng(hidden), 9, hidden, 60, torch.float64, "cpu")
    ops = decode_kernel.decode_padded_operands(*args)
    assert ops[1].shape == (9, 4, kc.round_up(hidden, 64))
    got, want = (decode_kernel.decode_sampling_reference(*a) for a in (ops, args))
    assert torch.equal(got[1], want[1])
    _close(got[:1], want[:1])
    for dtype in (torch.float32, torch.bfloat16):
        args = _decode_case(np.random.default_rng(hidden + 1), 9, hidden, 60, dtype, "cpu",
                            big_row=2)
        got, want = (decode_kernel.decode_sampling_int8_reference(*a)
                     for a in (decode_kernel.decode_padded_operands(*args), args))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("hidden,ctx", [(48, 100), (100, 48), (16, 16)])
def test_plain_k7_on_zero_units_is_the_narrow_decode(float64_plain, hidden, ctx):
    """K7's plain version on ``arnn_padded_operands``, H and C padded each
    on its own (H 48 with C 100 runs at 64 and 128): the narrow model's
    logits (within 1e-12) and tokens (equal)."""
    args = _arnn_case(np.random.default_rng(hidden), 5, hidden, ctx, 40, 30, 20, torch.float64,
                      "cpu")
    params, ctx_p = arnn_kernel.arnn_padded_operands(args[0], args[1])
    assert ctx_p.shape[-1] == kc.round_up(ctx, 64)
    assert params["lstm_generation"][0]["w_hh"].shape == (kc.round_up(hidden, 64),
                                                          4 * kc.round_up(hidden, 64))
    got = arnn_kernel.arnn_sampled_decode_reference(params, ctx_p, *args[2:])
    want = arnn_kernel.arnn_sampled_decode_reference(*args)
    assert torch.equal(got[1], want[1])
    _close(got[:1], want[:1])


def _gate_major(monkeypatch):
    monkeypatch.setattr(kc, "gate_padding", lambda: 1)


def _padded_weight_sets(hidden: int = 100) -> dict:
    """{kernel: a callable returning the padded weight tensors its wrapper
    builds} at ``hidden``, f32 on the CPU."""
    xw, w, b, h0, _ = _gru_layer_case(np.random.default_rng(0), 5, 7, hidden, torch.float32,
                                      "cpu", None)
    gru, table, tokens, _ = _encoder_case(hidden, torch.float32)
    dec = _decode_case(np.random.default_rng(2), 9, hidden, 60, torch.float32, "cpu")
    arnn = _arnn_case(np.random.default_rng(3), 5, hidden, 48, 40, 30, 20, torch.float32, "cpu")
    return {
        "K8": lambda: lk.padded_operands(xw, w, b, h0)[1:3],
        "K5/K6": lambda: tk.fwd_padded_operands(w, b, xw, h0)[:2],
        "K1/K3": lambda: [t for layer in encoder_kernel.encoder_padded_operands(gru)[0]
                          for c in layer for t in c.values()],
        "K2/K4": lambda: [t for layer in decode_kernel.decode_padded_operands(*dec)[0]["tick_gru"]
                          for t in layer[0].values()],
        "K7": lambda: [t for c in arnn_kernel.arnn_padded_operands(*arnn[:2])[0]["lstm_generation"]
                       for t in c.values()],
    }


@pytest.mark.parametrize("kernel", ["K8", "K5/K6", "K1/K3", "K2/K4", "K7"])
def test_padded_weights_built_under_inference_mode_are_cached(kernel):
    """An engine's or a tester's first call runs under
    ``torch.inference_mode``: the padded weights its wrapper builds there
    are ordinary tensors (they count versions), the same tensors on every
    later call, so a ``WeightCache`` of operands built from them (the
    kernels' packings) builds once and a CUDA graph capture finds it
    built."""
    padded = _padded_weight_sets()[kernel]
    builds = []
    packing = kc.WeightCache(lambda *ws: builds.append(1) or len(ws))
    with torch.inference_mode():
        first = padded()
        for _ in range(3):
            again = padded()
            assert all(a is f for a, f in zip(again, first))
            packing(*again)
    assert not any(t.is_inference() or t.requires_grad for t in first)
    assert builds == [1]


def test_gate_major_padding_is_rejected(float64_plain, monkeypatch):
    """The planted fault: the 3H (4H) gate columns padded as a whole at the
    end (``kernel_common.gate_padding`` 1) moves every plain version's
    outputs far past its bound (and K3's and K4's off bit-equality); the
    padded operands are cached per layout, so the same weights build the
    faulty ones."""
    hidden = 100
    xw, w, b, h0, _ = _gru_layer_case(np.random.default_rng(0), 5, 7, hidden, torch.float64,
                                      "cpu", None)
    fwd, dys, hprev = _train_case(np.random.default_rng(1), 4, hidden, 3, torch.float64, "cpu")
    gru, table, tokens, _ = _encoder_case(hidden, torch.float64)
    dec = _decode_case(np.random.default_rng(2), 9, hidden, 60, torch.float64, "cpu")
    arnn = _arnn_case(np.random.default_rng(3), 5, hidden, 48, 40, 30, 20, torch.float64, "cpu")

    def runs():
        yield "K8", lk.gru_layer_reference(*lk.padded_operands(xw, w, b, h0))[1][:, :hidden], \
            lk.gru_layer_reference(xw, w, b, h0)[1]
        padded = tk.fwd_padded_operands(*fwd)
        out = tk.gru_fwd_seq_reference(*padded)
        yield "K5", out[0][..., :hidden], tk.gru_fwd_seq_reference(*fwd)[0]
        width = out[0].shape[-1]
        yield "K6", tk.gru_bwd_seq_reference(
            padded[0], kc.pad_units(dys, hidden, width), *out[1:],
            kc.pad_units(hprev, hidden, width))[2][:, :hidden], \
            tk.gru_bwd_seq_reference(fwd[0], dys, *tk.gru_fwd_seq_reference(*fwd)[1:], hprev)[2]
        yield "K1", encoder_kernel.encoder_hn_reference(
            encoder_kernel.encoder_padded_operands(gru)[0], table, tokens)[..., :hidden], \
            encoder_kernel.encoder_hn_reference(gru, table, tokens)
        yield "K3", encoder_kernel.encoder_hn_int8_reference(
            encoder_kernel.encoder_padded_operands(gru)[0], table, tokens)[..., :hidden], \
            encoder_kernel.encoder_hn_int8_reference(gru, table, tokens)
        yield "K2", decode_kernel.decode_sampling_reference(
            *decode_kernel.decode_padded_operands(*dec))[0], \
            decode_kernel.decode_sampling_reference(*dec)[0]
        yield "K4", decode_kernel.decode_sampling_int8_reference(
            *decode_kernel.decode_padded_operands(*dec))[0], \
            decode_kernel.decode_sampling_int8_reference(*dec)[0]
        params, ctx = arnn_kernel.arnn_padded_operands(*arnn[:2])
        yield "K7", arnn_kernel.arnn_sampled_decode_reference(params, ctx, *arnn[2:])[0], \
            arnn_kernel.arnn_sampled_decode_reference(*arnn)[0]

    for name, got, want in runs():  # per gate: exact
        assert (got - want).abs().max().item() <= EXACT, name
    _gate_major(monkeypatch)
    for name, got, want in runs():
        assert (got - want).abs().max().item() > 1e-2, name


# --------------------------------------------------------------------------- #
# The JAX package's kernels at H 16 against the port's kernel routes there
# --------------------------------------------------------------------------- #
def test_jax_kernels_at_h16_match_the_port_routes():
    """K1, K2 and K7 of the JAX package at H 16 (interpret mode, as its own
    tests run them) against the port's wrappers there (the kernel routes,
    whose gates now take H 16: their plain versions on the CPU) and against
    the plain versions on the padded operands, sliced back: f32, the
    bounds of the port's H-32/64 parity tests (1e-5, tokens equal)."""
    import jax
    import jax.numpy as jnp

    from inpaintnet_tpu.ops.decode_pallas import decode_sampling_pallas
    from inpaintnet_tpu.ops.encoder_pallas import encoder_hn_pallas
    from inpaintnet_tpu_torch.models.measure_vae import Encoder, HierarchicalDecoder
    from test_torch_arnn import _k7_case, make_pair
    from test_torch_decode_kernel import _setup
    from test_torch_encoder_kernel import _inputs, _torch

    port_self = SimpleNamespace(num_layers=2, rnn_hidden_size=16)
    assert Encoder.use_kernel(port_self) and HierarchicalDecoder.use_kernel(port_self)
    params, table, tokens = _inputs(13, 16, 30, seed=4)
    want = np.asarray(encoder_hn_pallas(jax.tree_util.tree_map(jnp.asarray, params),
                                        jnp.asarray(table), jnp.asarray(tokens), tile_b=8,
                                        interpret=True))
    args = (_torch(params), torch.from_numpy(table), torch.from_numpy(tokens))
    np.testing.assert_allclose(encoder_kernel.encoder_hn(*args).numpy(), want, atol=1e-5)
    padded = encoder_kernel.encoder_hn_reference(encoder_kernel.encoder_padded_operands(args[0])[0],
                                                 *args[1:])
    np.testing.assert_allclose(padded[..., :16].numpy(), want, atol=1e-5)

    _, params, tick_ctx, h_inits = _setup(13, hidden=16, seed=4)
    lg_j, s_j = decode_sampling_pallas(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    args = [jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), t)
            for t in (params, tick_ctx, h_inits)]
    for lg, s in (decode_kernel.decode_sampling(*args),
                  decode_kernel.decode_sampling_reference(
                      *decode_kernel.decode_padded_operands(*args))):
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=1e-5)

    jm, pm = make_pair(16, seed=2)
    assert pm._use_kernel_decode(pm.params())
    port, lg_j, tok_j = _k7_case(jm, 11, 96, jnp.float32, seed=3)
    params, ctx = arnn_kernel.arnn_padded_operands(*port[:2])
    for lg, tok in (arnn_kernel.arnn_sampled_decode(*port),
                    arnn_kernel.arnn_sampled_decode_reference(params, ctx, *port[2:])):
        np.testing.assert_array_equal(tok.numpy(), tok_j)
        np.testing.assert_allclose(lg.numpy(), lg_j, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------- #
# The trainfast Function at H 100 and 1024 against the eager loop
# --------------------------------------------------------------------------- #
TRAIN_ATOL = 2e-5  # f32 on both sides (docs/PARITY.md §2, as the VAE's parity tests)


@pytest.mark.parametrize("hidden", [100, 1024])
def test_trainfast_at_every_width_matches_the_eager_loop(monkeypatch, hidden):
    """Loss and every gradient of the trainfast Function (K5/K6's plain
    versions here) against autograd through the eager loop, both
    directions, few rows and steps."""
    rng = np.random.default_rng(hidden)
    p = {k: torch.from_numpy(v) for k, v in gru_init(rng, 8, hidden, 1)[0][0].items()}
    x = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    h0 = torch.from_numpy(0.5 * rng.standard_normal((3, hidden)).astype(np.float32))
    wy = torch.from_numpy(rng.standard_normal((3, 4, hidden)).astype(np.float32))
    assert tk.trainfast_supports(hidden)

    def run(reverse):
        leaves = {k: v.clone().requires_grad_() for k, v in {**p, "x": x, "h0": h0}.items()}
        params = {k: leaves[k] for k in p}
        ys, h_last = gru_mod.gru_layer_apply(params, leaves["x"], leaves["h0"],
                                             reverse=reverse, train=True)
        loss = (ys * wy).sum() + h_last.sum()
        loss.backward()
        return [loss.detach()] + [leaves[k].grad for k in sorted(leaves)]

    for reverse in (False, True):
        calls, real = [], tk.gru_fwd_seq_reference
        monkeypatch.setattr(tk, "gru_fwd_seq_reference",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        fast = run(reverse)
        assert calls == [1]
        monkeypatch.setattr(gru_mod, "trainfast_supports", lambda h: False)
        eager = run(reverse)
        monkeypatch.undo()
        for got, want in zip(fast, eager):
            torch.testing.assert_close(got, want, rtol=0, atol=TRAIN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [100, 576, 960, 1024])
def test_trainfast_at_every_width_on_card_matches_cpu(cuda, hidden):
    """The autograd Function in f32 at H 100 (K5/K6 at 128, on zero units),
    576 and 960 (both at 640 and 1024, the next widths K6's 8 CTAs of at
    most 128 units take) and 1024 (K5 on a cluster of 16, K6 on 8 CTAs of
    128), padded once and K5's residuals handed to K6 at that width: K5 and
    K6 on the card against the plain versions on the CPU in float64, values
    and every gradient, with the bounds of
    ``test_torch_cuda_kernels.test_trainfast_function_on_card_matches_cpu``."""
    rng = np.random.default_rng(5)
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in gru_init(rng, 20, hidden, 1)[0][0].items()}
    x = rng.standard_normal((37, 6, 20)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((37, hidden))).astype(np.float32)
    wy = rng.standard_normal((37, 6, hidden)).astype(np.float32)

    def run(device, dtype=torch.float32):
        tp = {k: torch.from_numpy(v).to(device, dtype).requires_grad_() for k, v in p.items()}
        tx, th0 = (torch.from_numpy(a).to(device, dtype).requires_grad_() for a in (x, h0))
        ys, h_last = gru_layer_trainfast(tp, tx, th0)
        loss = (ys * torch.from_numpy(wy).to(device, dtype)).sum() + h_last.sum()
        loss.backward()
        return [loss.detach()] + [tp[k].grad for k in sorted(tp)] + [tx.grad, th0.grad]

    before = (tk.gru_fwd_seq.launches, tk.gru_bwd_seq.launches)
    card = run(cuda)
    torch.cuda.synchronize()
    assert (tk.gru_fwd_seq.launches, tk.gru_bwd_seq.launches) == (before[0] + 1, before[1] + 1)
    for got, want in zip(card, run("cpu", torch.float64)):
        torch.testing.assert_close(got.cpu(), want.float(), rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------------------- #
# The serving engines at narrow widths on the card, both routes
# --------------------------------------------------------------------------- #
def _same(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and np.array_equal(a, b)


def _both_routes(engine, calls, kernels) -> None:
    """Each call eagerly, then on the graph route twice (its capture, then
    a replay): bit-equal tokens, and each of ``kernels`` launched by the
    eager call and as often by the replay."""
    for call in calls:
        engine.graphs = False
        before = [k.launches for k in kernels]
        eager = call(engine)
        eager_launches = [k.launches - n for k, n in zip(kernels, before)]
        engine.graphs = True
        call(engine)
        before = [k.launches for k in kernels]
        graph = call(engine)
        assert _same(graph, eager)
        assert [k.launches - n for k, n in zip(kernels, before)] == eager_launches
        assert min(eager_launches) > 0, eager_launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,impl", [("bfloat16", "xla"), ("int8", "xla"),
                                        ("bfloat16", "pallas"), ("float32", "pallas")])
def test_latent_engine_at_h100_graph_route_equals_eager_route(cuda, dtype, impl):
    """An engine over a VAE and LatentRNN of H 100 (K1-K4 at 128 and, on
    ``"pallas"``, K8 at 128, on zero units): its padded weights, built on
    the first eager call under ``inference_mode``, are found built by the
    capture."""
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    model = build_flagship(vocab_size=30, hidden=100, z_dim=8, emb=6, seed=0, device=cuda)[2]
    engine = InpaintingEngine(model, batch_buckets=(1, 4), dtype=dtype, n_bars=8, device=cuda)
    kernels = ([encoder_kernel.encoder_hn_int8, decode_kernel.decode_sampling_int8]
               if dtype == "int8" else [encoder_kernel.encoder_hn, decode_kernel.decode_sampling])
    if impl == "pallas":
        kernels.append(lk.gru_layer_stream)
    tokens = np.random.default_rng(0).integers(0, 30, (3, 8, 24)).astype(np.int32)
    with gru_mod.gru_impl_scope(impl):
        _both_routes(engine, [lambda e: e.inpaint(tokens, 3, 2, seed=7),
                              lambda e: e.inpaint_variations(tokens, 3, 2, 2, seed=3)], kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arnn_engine_at_h48_c100_graph_route_equals_eager_route(cuda, dtype):
    """The ARNN engine with a generation LSTM of H 48 and a constraint LSTM
    of C 100 (K7 at 64 and 128, each padded on its own)."""
    from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
    from inpaintnet_tpu_torch.models.presets import ARNNDataset
    from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

    arnn = AnticipationRNNBaseline(
        ARNNDataset(30), note_embedding_dim=8, metadata_embedding_dim=4,
        num_lstm_constraints_units=100, num_lstm_generation_units=48, linear_hidden_size=64,
        num_layers=2, unary_constraint=True, device=cuda, seed=0)
    engine = ARNNServingEngine(arnn, batch_buckets=(1, 4), dtype=dtype, max_measures=8,
                               device=cuda)
    tokens = np.random.default_rng(1).integers(0, 30, (3, 8, 24)).astype(np.int32)
    _both_routes(engine, [lambda e: e.inpaint(tokens, 3, 2), lambda e: e.inpaint(tokens[:1], 2, 4)],
                 [arnn_kernel.arnn_sampled_decode])
