"""The heads of K2, K4 and K7 over vocabularies wider than one chunk of the
port's Hopper routes (96 columns for K2 and K4, 64 for K7) and than the JAX
kernels' 128-column padding: the port's plain versions against the JAX
package's kernels (interpret mode), on heads whose maximum ties across
those chunk borders; the packed layouts of the chunked heads; and the
port's gates against the JAX package's at every geometry of a grid."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.anticipation_rnn import AnticipationRNNBaseline as JaxARNN
from inpaintnet_tpu.models.anticipation_rnn import ConstraintModelGaussianReg as JaxCMGR
from inpaintnet_tpu.models.measure_vae import HierarchicalDecoder as JaxHD
from inpaintnet_tpu.models.base import cast_pytree
from inpaintnet_tpu.ops.arnn_pallas import arnn_sampled_decode_pallas
from inpaintnet_tpu.ops.decode_pallas import decode_sampling_pallas, decode_sampling_pallas_int8
from inpaintnet_tpu_torch.models.anticipation_rnn import ConstraintModelGaussianReg as PortCMGR
from inpaintnet_tpu_torch.models.measure_vae import HierarchicalDecoder as PortHD
from inpaintnet_tpu_torch.ops import arnn_kernel, decode_kernel, kernel_common

from test_torch_arnn import JaxDS, _tensors, _t
from test_torch_decode_kernel import _setup, _torch
from test_torch_int8_kernels import (LOGITS_ATOL, LOGITS_MEAN_ATOL, TOKEN_SHARE, _fed_back_same,
                                     _to_torch)
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

# K2 f32, the plain version against the JAX kernel: tokens equal, logits
# within 1e-5 (f32 on both sides, only the sums' order differs), as
# test_torch_decode_kernel's parity test holds them. K4: its bounds of
# test_torch_int8_kernels (TOKEN_SHARE, LOGITS_ATOL, LOGITS_MEAN_ATOL). K7:
# test_torch_arnn's, f32 tokens equal and logits within 1e-5, bf16 K7_BF16.
K2_ATOL = 1e-5
K7_F32_ATOL = 1e-5
K7_BF16 = {"tokens": 1.0, "max": 4e-3, "mean": 1e-5, "early": 0.15}


def _tie(head: dict, pairs, lift: float) -> dict:
    """``head`` (JAX params {"w": (in, V), "b": (V,)}) with column ``a``
    copied into column ``b`` for each (a, b) of ``pairs`` and both biases
    raised by ``lift``: equal logits on either side of a chunk border, the
    largest on many ticks."""
    w, b = np.array(head["w"], np.float32), np.array(head["b"], np.float32)
    for a, c in pairs:
        w[:, c] = w[:, a]
        b[a] += lift
        b[c] = b[a]
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}


# (V, tied columns): across the port's 96-column chunk border and the JAX
# kernels' 128-column padding (K2, K4)
K2_TIES = {97: ((3, 96),), 256: ((3, 99), (40, 168), (130, 200))}


def _k2_inputs(vocab: int, batch: int = 13, hidden: int = 64, seed: int = 0):
    _, params, tick_ctx, h_inits = _setup(batch, vocab=vocab, hidden=hidden, seed=seed)
    params = dict(params, head=_tie(params["head"], K2_TIES[vocab], 0.3))
    return params, tick_ctx, h_inits


def _assert_first_of_ties(tokens: np.ndarray, pairs) -> None:
    """The later column of a tied pair wins on no tick, and the ties were
    the largest logits on some (an earlier column won there)."""
    assert not any((tokens == c).any() for _, c in pairs)
    assert any((tokens == a).any() for a, _ in pairs)


@pytest.mark.parametrize("vocab", [97, 256])
def test_plain_k2_matches_jax_kernel_over_chunk_borders(vocab):
    params, tick_ctx, h_inits = _k2_inputs(vocab)
    lg, s = decode_kernel.decode_sampling_reference(*map(_torch, (params, tick_ctx, h_inits)))
    pw, ps = decode_sampling_pallas(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    assert lg.shape == (13, 24, vocab)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ps))
    np.testing.assert_allclose(lg.numpy(), np.asarray(pw), atol=K2_ATOL)
    _assert_first_of_ties(s.numpy(), K2_TIES[vocab])


@pytest.mark.parametrize("vocab,dtype", [(97, "bfloat16"), (256, "float32"),
                                         (256, "bfloat16")])
def test_plain_k4_matches_jax_kernel_over_chunk_borders(vocab, dtype):
    params, tick_ctx, h_inits = (jax.tree_util.tree_map(lambda x: x.astype(dtype), t)
                                 for t in _k2_inputs(vocab, seed=1))
    lg, s = decode_kernel.decode_sampling_int8_reference(
        *(_to_torch(t, dtype) for t in (params, tick_ctx, h_inits)))
    pw, ps = decode_sampling_pallas_int8(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    pw, ps = np.asarray(pw.astype(jnp.float32)), np.asarray(ps)
    assert (s.numpy() == ps).mean() >= TOKEN_SHARE
    seen = _fed_back_same(s.numpy(), ps)
    err = np.abs(lg.float().numpy()[seen] - pw[seen])
    assert err.max() <= LOGITS_ATOL and err.mean() <= LOGITS_MEAN_ATOL, (err.max(), err.mean())
    _assert_first_of_ties(s.numpy(), K2_TIES[vocab])


def test_decode_packs_the_head_in_chunks():
    """K2 bf16 / K4's packed head: chunk c's row r is the head's column 96 c
    + r, zero past V; K2 f32's: each chunk one pair of 48-row blocks of its
    three pieces; the padded biases and scales cover whole chunks."""
    hidden, vocab = 64, 200
    rng = np.random.default_rng(5)
    ws = [torch.from_numpy(rng.standard_normal((hidden, 3 * hidden)).astype(np.float32))
          for _ in range(3)]
    head = torch.from_numpy(rng.standard_normal((hidden, vocab)).astype(np.float32))
    chunks = decode_kernel.head_chunks(vocab)
    assert chunks == 3 and decode_kernel.head_chunks(96) == 1
    assert decode_kernel.head_chunks(97) == 2
    packed = decode_kernel.pack_decode_weights(*ws, head)
    gru_chunks = 3 * hidden // 32
    assert packed.shape == (gru_chunks + chunks, hidden // 64, 96, 64)
    want = torch.zeros(chunks * 96, hidden)
    want[:vocab] = head.t()
    for c in range(chunks):
        for k in range(hidden // 64):
            torch.testing.assert_close(packed[gru_chunks + c, k],
                                       want[96 * c: 96 * c + 96, 64 * k: 64 * k + 64],
                                       rtol=0, atol=0)
    f32 = decode_kernel.pack_decode_f32_weights(*ws, head)
    pairs = hidden // 32
    assert f32.shape == ((3 * pairs + chunks) * (hidden // 64) * 6, 48, 64)
    pieces = kernel_common.split_bf16_pieces(want)
    base = 3 * pairs * (hidden // 64) * 6
    for c in range(chunks):
        for p in range(3):
            for half in range(2):
                got = f32[base + (c * (hidden // 64)) * 6 + 2 * p + half].float()
                rows = slice(96 * c + 48 * half, 96 * c + 48 * half + 48)
                torch.testing.assert_close(got, pieces[p][rows, :64].float(), rtol=0, atol=0)
    assert decode_kernel._head_pad(vocab) == (0, 3 * 96 - vocab)


def _jax_arnn(vocab: int, hidden: int = 64, seed: int = 0):
    ds = JaxDS()
    ds.note2index_dicts = [{f"t{i}": i for i in range(vocab)}]
    jm = JaxARNN(ds, note_embedding_dim=8, metadata_embedding_dim=4,
                 num_lstm_constraints_units=hidden, num_lstm_generation_units=hidden,
                 linear_hidden_size=12, num_layers=2, unary_constraint=True)
    jm.init(jax.random.PRNGKey(seed))
    return jm


# (V, tied columns) of K7's head: across the port's 64-column chunks and the
# JAX kernel's 128-column padding
K7_TIES = {90: ((3, 64), (10, 88)), 256: ((3, 70), (20, 130), (129, 255))}


def _k7_inputs(vocab: int, dtype_j, batch: int = 11, seq_len: int = 96, seed: int = 0):
    jm = _jax_arnn(vocab, seed=seed)
    params = dict(jm.params, linear_output_notes=_tie(jm.params["linear_output_notes"],
                                                      K7_TIES[vocab], 1.0))
    p = cast_pytree(params, dtype_j)
    rs = np.random.RandomState(seed)
    ctx = (0.5 * rs.standard_normal((batch, seq_len, 64))).astype(np.float32)
    score = rs.randint(0, vocab, (batch, seq_len)).astype(np.int32)
    fm = np.ones((batch, seq_len), np.int32)
    fm[:, seq_len // 3:] = 0
    ctx_j = jnp.asarray(ctx, dtype_j)
    start = p["note_embedding"]["table"][:1]
    logits, tokens = arnn_sampled_decode_pallas(p, ctx_j, jnp.asarray(score), jnp.asarray(fm),
                                                start, tile_b=8, interpret=True)
    tdt = torch.bfloat16 if dtype_j == jnp.bfloat16 else torch.float32
    port = (_tensors(p, tdt), torch.from_numpy(np.array(ctx_j.astype(jnp.float32))).to(tdt),
            *_t(score, fm), torch.from_numpy(np.array(start.astype(jnp.float32))).to(tdt))
    return port, (np.asarray(logits.astype(jnp.float32)), np.asarray(tokens))


@pytest.mark.parametrize("vocab,dtype_j", [(90, jnp.float32), (256, jnp.float32),
                                           (90, jnp.bfloat16), (256, jnp.bfloat16)])
def test_plain_k7_matches_jax_kernel_over_chunk_borders(vocab, dtype_j):
    port, (lg_j, tok_j) = _k7_inputs(vocab, dtype_j)
    lg, tok = arnn_kernel.arnn_sampled_decode_reference(*port)
    assert lg.shape == (11, 96, vocab)
    sampled = tok.numpy()[:, 32:]  # the unforced ticks
    _assert_first_of_ties(sampled, K7_TIES[vocab])
    if dtype_j == jnp.float32:
        np.testing.assert_array_equal(tok.numpy(), tok_j)
        np.testing.assert_allclose(lg.numpy(), lg_j, atol=K7_F32_ATOL, rtol=0)
        return
    agree = arnn_kernel.decode_agreement((lg, tok), (torch.from_numpy(lg_j.copy()),
                                                     torch.from_numpy(tok_j.copy())), port[3])
    assert arnn_kernel.within(agree, K7_BF16), agree


def test_arnn_packs_the_output_head_in_chunks():
    """K7's W_out^T by chunks of 64 columns, zero past V: the f32 route's
    pieces by pairs of chunks (a zero chunk after an odd last one), the
    bf16 route's chunks by halves of 32 columns, four k-slabs a block (the
    head padded to 256)."""
    hidden, linear, vocab = 64, 100, 150
    rng = np.random.default_rng(6)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w_hh0, w_ih1, w_hh1 = (rand(hidden, 4 * hidden) for _ in range(3))
    w_l1, w_out = rand(hidden, linear), rand(linear, vocab)
    assert arnn_kernel.arnn_out_chunks(vocab) == 3
    packed = arnn_kernel.pack_arnn_f32_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out)
    kb, lp = hidden // 64, arnn_kernel.arnn_head_width(linear)
    base = 3 * (hidden // 32) * kb * 6 + lp // 128 * kb * 6
    assert packed.shape == (base + 2 * (lp // 64) * 6, 64, 64)
    full = torch.zeros(lp, 256)
    full[:linear, :vocab] = w_out
    pieces = kernel_common.split_bf16_pieces(full)
    for pr in range(2):
        for k in range(lp // 64):
            for p in range(3):
                for chunk in range(2):
                    cols = slice(128 * pr + 64 * chunk, 128 * pr + 64 * chunk + 64)
                    want = pieces[p][64 * k: 64 * k + 64, cols].t()
                    got = packed[base + (pr * (lp // 64) + k) * 6 + 2 * p + chunk].float()
                    torch.testing.assert_close(got, want.float(), rtol=0, atol=0)
    assert arnn_kernel.arnn_out_kslabs(hidden, lp) == 4
    bf16 = arnn_kernel.pack_arnn_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out)
    out = bf16[-6:].reshape(3, 2, 4, 32, 64)  # (chunk, half, k-slab, row, k): LP 128 in one block
    for c in range(3):
        for half in range(2):
            for k in range(4):
                cols = slice(64 * c + 32 * half, 64 * c + 32 * half + 32)
                want = full[64 * k: 64 * k + 64, cols].t() if k < lp // 64 else torch.zeros(32, 64)
                torch.testing.assert_close(out[c, half, k], want, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# The gates: every geometry the JAX package's kernels take (its gates opened
# as on a TPU), within the port's hidden gate, runs a Hopper route of the
# port's
# --------------------------------------------------------------------------- #
WIDTHS = range(64, 513, 64)
LINEARS = (64, 256, 512, 1024)
VOCABS = (30, 60, 64, 65, 90, 96, 97, 128, 256, 1280)
DTYPES = ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32))


@pytest.fixture
def on_tpu(monkeypatch):
    """JAX's gates as on a TPU (its kernels' default implementations)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("INPAINTNET_DECODE_IMPL", raising=False)
    monkeypatch.delenv("INPAINTNET_ARNN_IMPL", raising=False)


def test_k2_k4_gates_cover_the_jax_gate(on_tpu):
    taken = 0
    for hidden in WIDTHS:
        port = PortHD.use_kernel(SimpleNamespace(num_layers=2, rnn_hidden_size=hidden))
        assert port == kernel_common.decode_supports_hidden(hidden)
        for vocab in VOCABS:
            for dtype_j, dtype_t in DTYPES:
                jax_self = SimpleNamespace(num_layers=2, sampling="argmax",
                                           rnn_hidden_size=hidden, num_notes=vocab)
                params = {"tick_gru": [[{"w_hh": jnp.zeros((1, 1), dtype_j)}]]}
                if not JaxHD._use_pallas_decode(jax_self, params):
                    continue
                taken += 1
                assert port, (hidden, vocab, dtype_t)
                assert decode_kernel.decode_supports(hidden, dtype_t), (hidden, vocab, dtype_t)
                assert decode_kernel.decode_supports(hidden, "int8"), (hidden, vocab)
    assert taken >= 100  # the grid is not vacuous: the JAX gate takes most of it


def test_k7_gate_covers_the_jax_gate(on_tpu):
    taken = 0
    for hidden in WIDTHS:
        for ctx in WIDTHS:
            for linear in LINEARS:
                for vocab in VOCABS:
                    for dtype_j, dtype_t in DTYPES:
                        jax_self = SimpleNamespace(
                            num_layers=2, num_lstm_generation_units=hidden,
                            num_lstm_constraints_units=ctx, num_units_linear=linear,
                            num_notes=vocab)
                        params = {"lstm_generation": [{"w_hh": jnp.zeros((1, 1), dtype_j)}],
                                  "note_embedding": {"table": np.zeros((vocab + 1, 1))}}
                        if not JaxCMGR._use_pallas_decode(jax_self, params):
                            continue
                        taken += 1
                        geometry = (hidden, ctx, linear, vocab, dtype_t)
                        port_self = SimpleNamespace(
                            num_layers=2, num_lstm_generation_units=hidden,
                            num_lstm_constraints_units=ctx, num_units_linear=linear,
                            num_notes=vocab)
                        port_params = {"lstm_generation": [{"w_hh": torch.zeros(1,
                                                                                dtype=dtype_t)}]}
                        assert PortCMGR._use_kernel_decode(port_self, port_params), geometry
                        assert arnn_kernel._route_supports(hidden, linear, vocab, dtype_t), \
                            geometry
                        assert arnn_kernel.arnn_cuda_launches(dtype_t, 64, 384, hidden, linear,
                                                              vocab) == 2, geometry
    assert taken >= 1000
