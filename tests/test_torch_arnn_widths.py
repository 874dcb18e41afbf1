"""K7 at every geometry the JAX package's kernel gate takes: a context
width C above 512 in both dtypes (C enters only the context projection
GEMM, whose depth is any whole number of 64-column slabs), and bf16 H from
513 to 640 (two h tiles of 64 x H leave no cluster room for rings of whole
16 KB k-slabs: half-slab boxes on clusters of 9 and 10 CTAs).

- the plans: every bf16 H from 513 to 640 runs at 576 or 640 within the
  227 KB opt-in, at every head and vocabulary, and every width up to 512
  keeps its whole-slab plan;
- the port's K7 entry point (its plain version on the CPU) against the JAX
  package's ``_sampled_scan`` at C 600, bf16 H 576 and 600 and f32 H 256;
- the plain version on the padded operands (C 600 at 640, H 600 at 640)
  against the narrow one, in float64;
- on the card: the kernel against its plain version at the new widths,
  the first-index tie across a head chunk with its planted fault, and the
  context GEMM at the padded depth.

JAX is imported inside the test that compares with it, so the card's tests
run on a machine without it:

    python -m pytest tests/test_torch_arnn_widths.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import arnn_kernel as ak
from inpaintnet_tpu_torch.ops import kernel_common as kc

from test_torch_cuda_kernels import (  # noqa: F401  (the card's fixtures)
    _arnn_case,
    cuda,
    later_chunk_wins_ties,
)
from test_torch_hidden_widths import EXACT, _close, _one_torch_thread, float64_plain  # noqa: F401

BF16 = torch.bfloat16
SMS = 132  # an H100 SXM
# An H100 runs one cluster of 9 or 10 such CTAs a GPC: these are the
# slots the plans are held to here (the card's own count comes from
# ``arnn_slots``)
WIDE_SLOTS = {9: 7, 10: 7}


# --------------------------------------------------------------------------- #
# The plans
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("linear", [64, 256, 512])
def test_bf16_plans_take_every_width_to_640(linear):
    """Every bf16 H from 513 to 640 runs at 576 (9 blocks of 64) or 640
    (10), on half-slab boxes (whole slabs fit no cluster size there), one
    64-unit block a CTA, within the budget, two CUDA launches a call, at
    V 60 and 256; f32 stops at 512."""
    lp = ak.arnn_head_width(linear)
    for hidden in range(513, 641):
        width = ak.arnn_width(hidden, BF16)
        assert width == (576 if hidden <= 576 else 640), hidden
        assert ak.arnn_box_halves(width) == 1
        sizes = ak.arnn_cluster_sizes(width, lp)
        assert sizes == [width // 64], (hidden, sizes)
        for c in range(1, 17):  # whole k-slab boxes leave no ring of two stages anywhere
            assert (width // 64) % c or width // c > ak.ARNN_MAX_UNITS or \
                ak.arnn_ring_stages(width, c, ak.ARNN_HID_COLS, halves=2) < 2, (width, c)
        for c in sizes:
            ht = ak.arnn_hid_cols(width, c, lp)
            stages = ak.arnn_ring_stages(width, c, ht)
            assert lp % ht == 0 and 2 <= stages <= kc.HOPPER_MAX_STAGES
            assert ak.arnn_smem_bytes(width, c, ht, stages) <= kc.HOPPER_SMEM_BUDGET
            assert ak.arnn_out_kslabs(width, lp) in (2, 4)
        plan = ak.arnn_plan(512, width, linear, SMS, WIDE_SLOTS)
        assert plan.cluster == width // 64 and plan.stages >= 2
        for vocab in (60, 256):
            assert ak.arnn_kernel_supports(hidden, 256, linear, vocab, BF16)
            assert not ak.arnn_kernel_supports(hidden, 256, linear, vocab, torch.float32)
            assert ak.arnn_cuda_launches(BF16, 512, 384, hidden, linear, vocab) == 2
    assert not ak.arnn_kernel_supports(641, 256, linear, 60, BF16)
    # H 640 takes the budget exactly: 160 KB of h tiles, a 16 KB hidden
    # tile, two stages of two 8 KB half-slab rings and 16 KB of c carries
    assert ak.arnn_smem_bytes(640, 10, 128, 2) == kc.HOPPER_SMEM_BUDGET == 230_400


def test_widths_up_to_512_keep_whole_slab_plans():
    """Below 576 every width keeps whole 16 KB k-slab boxes and the plans
    it had (the half boxes are only where nothing else fits)."""
    for hidden in range(64, 513, 64):
        assert ak.arnn_box_halves(hidden) == 2, hidden
        assert all(c <= 8 for c in ak.arnn_cluster_sizes(hidden, 256)), hidden
        assert ak.arnn_width(hidden, BF16) == ak.arnn_width(hidden, torch.float32) == hidden
    assert ak.arnn_cluster_sizes(512, 256) == [8] and ak.arnn_cluster_sizes(256, 256) == [1, 2, 4]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_context_width_has_no_cap(dtype):
    """C pads to whole 64-column slabs of the GEMM's depth at any width: the
    JAX gate's widest contexts (bf16 C 19,083 at H 64, 3,954 at H 256; f32
    1,513 at H 256) all run, two CUDA launches a call."""
    for ctx, want in ((1, 64), (64, 64), (65, 128), (600, 640), (1513, 1536), (3954, 3968),
                      (19083, 19136)):
        assert ak.arnn_ctx_width(ctx) == want
    for hidden, ctx in ((64, 19083), (256, 3954), (256, 1513), (512, 1024)):
        assert ak.arnn_kernel_supports(hidden, ctx, 256, 60, dtype), (hidden, ctx)
        assert ak.arnn_cuda_launches(dtype, 512, 384, hidden, 256, 60) == 2
    assert ak.arnn_ctx_width(0) is None and not ak.arnn_kernel_supports(64, 0, 256, 60, dtype)


# --------------------------------------------------------------------------- #
# The port's entry point against the JAX package's scan
# --------------------------------------------------------------------------- #
# K7's plain version (its f32 products and gates, h and c rounded to the
# parameter dtype each tick) against the JAX package's ``_sampled_scan``
# (the XLA scan its closed kernel gate falls back to, every op in the
# parameter dtype) on the same weights and inputs, 4 rows x 48 ticks. f32:
# tokens equal, logits within 1e-5 (both f32; seen 8e-8 at C 600). bf16:
# the scan rounds every product and gate to bf16 where the kernel keeps
# f32, so logits of |x| <= 0.12 differ by a few bf16 ulps (seen max 9.8e-4,
# two ulps of 0.12; mean 1.8e-4) and near-ties flip (tokens 0.979 and
# 0.995 at H 576 and 600, each row's first mismatch within 2.4e-4 of its
# top logit); no early-tick share, which that rounding moves everywhere.
SCAN_BF16 = {"tokens": 0.95, "max": 4e-3, "mean": 1e-3}


@pytest.mark.parametrize("hidden,dtype", [(576, BF16), (600, BF16), (256, torch.float32)])
def test_k7_matches_jax_sampled_scan_at_context_600(hidden, dtype):
    import jax
    import jax.numpy as jnp

    from inpaintnet_tpu.models.anticipation_rnn import ConstraintModelGaussianReg as JaxCMGR

    batch, ticks, ctx = 4, 48, 600
    args = _arnn_case(np.random.default_rng(hidden + ctx), batch, hidden, ctx, ticks, 60, 256,
                      dtype, "cpu", noise=0.0)
    assert ak.arnn_kernel_supports(hidden, ctx, 256, 60, dtype)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32

    def to_jax(t):
        return jnp.asarray(t.float().numpy(), jdt)
    jax_self = type("Gen", (), {"num_layers": 2, "num_lstm_generation_units": hidden,
                                "_head": lambda self, p, out: JaxCMGR._head(None, p, out)})()
    lg_j, tok_j = JaxCMGR._sampled_scan(
        jax_self, jax.tree_util.tree_map(to_jax, args[0]), to_jax(args[1]),
        jnp.asarray(args[2].numpy()), jnp.asarray(args[3].numpy()),
        start_emb=jnp.broadcast_to(to_jax(args[4]), (batch, args[4].shape[1])),
        temperature=None, train=False, rng=jax.random.PRNGKey(0))
    before = ak.arnn_sampled_decode.launches
    lg, tok = ak.arnn_sampled_decode(*args)  # CPU tensors: the plain version
    assert ak.arnn_sampled_decode.launches == before
    want = (torch.from_numpy(np.array(lg_j.astype(jnp.float32))),
            torch.from_numpy(np.array(tok_j)))
    assert lg.shape == (batch, ticks, 60) and lg.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(tok, want[1])
        np.testing.assert_allclose(lg.numpy(), want[0].numpy(), atol=1e-5, rtol=0)
        return
    agree = ak.decode_agreement((lg, tok), want, args[3])
    assert ak.within(agree, SCAN_BF16), agree


# --------------------------------------------------------------------------- #
# The plain version on the wrapper's padded operands, sliced back
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hidden,ctx,hp,cp", [(256, 600, 256, 640), (600, 600, 640, 640),
                                              (576, 3954, 576, 3968)])
def test_plain_k7_at_padded_widths_is_the_narrow_decode(float64_plain, hidden, ctx, hp, cp):
    """K7's plain version on ``arnn_padded_operands`` (C at its GEMM depth,
    H at the bf16 route's width) against the plain version at H and C in
    float64: tokens equal, logits within 1e-12 (the zero columns add exact
    zeros; only the sums' blocking moves)."""
    args = _arnn_case(np.random.default_rng(hidden + ctx), 3, hidden, ctx, 24, 30, 20,
                      torch.float64, "cpu")
    params, ctx_p = ak.arnn_padded_operands(args[0], args[1])
    assert ctx_p.shape[-1] == cp
    assert params["lstm_generation"][0]["w_hh"].shape == (hp, 4 * hp)
    assert params["lstm_generation"][0]["w_ih"].shape == (10 + cp, 4 * hp)
    got = ak.arnn_sampled_decode_reference(params, ctx_p, *args[2:])
    want = ak.arnn_sampled_decode_reference(*args)
    assert torch.equal(got[1], want[1])
    _close(got[:1], want[:1], EXACT)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
# K7 against its plain version at these shapes (70 rows: two row tiles, one
# ragged; 48 ticks; the layers' initialisation) within the card tests' K7
# bounds (test_torch_cuda_kernels.py), the planted fault (a c carry kept in
# f32) outside them.
CARD_CASES = [(576, 256, 256, 60, BF16), (600, 64, 256, 90, BF16), (640, 16, 128, 60, BF16),
              (619, 16, 512, 256, BF16), (256, 1024, 256, 60, BF16),
              (256, 3954, 256, 60, BF16), (256, 1513, 256, 60, torch.float32),
              (128, 600, 64, 90, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,ctx,linear,vocab,dtype", CARD_CASES)
def test_k7_at_wide_geometries_matches_plain_on_card(cuda, monkeypatch, hidden, ctx, linear,
                                                     vocab, dtype):
    """The kernel within the bounds of its plain version, one launch; in
    bf16 the planted fault (a c carry kept in f32) breaks the same bounds."""
    from test_torch_cuda_kernels import K7_BOUNDS

    args = _arnn_case(np.random.default_rng(hidden + ctx), 70, hidden, ctx, 48, vocab, linear,
                      dtype, cuda, noise=0.0)
    bound = K7_BOUNDS[dtype]
    before = ak.arnn_sampled_decode.launches
    got = ak.arnn_sampled_decode(*args)
    want = ak.arnn_sampled_decode_reference(*args)
    torch.cuda.synchronize()
    assert ak.arnn_sampled_decode.launches == before + 1
    assert got[0].shape == (70, 48, vocab) and got[0].dtype == dtype
    force = args[3] > 0
    assert torch.equal(got[1][force], args[2][force])
    agree = ak.decode_agreement(got, want, args[3])
    assert ak.within(agree, bound), (agree, bound)
    if dtype == BF16:
        monkeypatch.setattr(ak, "carry_c", lambda c, dtype: c)
        planted = ak.decode_agreement(got, ak.arnn_sampled_decode_reference(*args), args[3])
        assert not ak.within(planted, bound), planted


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [576, 640])
def test_k7_wide_heads_take_the_first_index_on_card(cuda, later_chunk_wins_ties, hidden):
    """At H 576 and 640 (half-slab boxes, clusters of 9 and 10) a tie
    across the first output chunk border goes to the first index, as in
    the plain version; the planted fault (a later chunk wins ties) does
    not."""
    params, ctx, score, force, _ = _arnn_case(np.random.default_rng(hidden), 70, hidden, 64, 24,
                                              130, 256, BF16, cuda)
    w, b = params["linear_output_notes"]["w"].clone(), params["linear_output_notes"]["b"].clone()
    w[:, 5 + ak.ARNN_OUT_COLS] = w[:, 5]
    b[5] += 8.0
    b[5 + ak.ARNN_OUT_COLS] = b[5]
    params = {**params, "linear_output_notes": {"w": w, "b": b}}
    args = (params, ctx, score, force, params["note_embedding"]["table"][130:].contiguous())
    want = ak.arnn_sampled_decode_reference(*args)[1]
    got = ak.arnn_sampled_decode(*args)[1]
    later_chunk_wins_ties()
    fault = ak.arnn_sampled_decode(*args)[1]
    torch.cuda.synchronize()
    assert bool((want[force == 0] == 5).all())
    assert torch.equal(got, want)
    assert not torch.equal(fault, want)


@pytest.mark.cuda
def test_k7_context_gemm_adds_exact_zeros_at_the_padded_depth(cuda):
    """The bf16 route's context projection GEMM on a context of C 600 at
    its depth 640 and one 64-column slab deeper (more zero columns against
    zero rows of W_ctx^T): bit-equal, so the padded depth takes the real
    columns' one sum; and the f32 split GEMM likewise."""
    from inpaintnet_tpu_torch.ops.kernel_common import load_kernels, split_bf16_pieces, stream_ptr

    rng = np.random.default_rng(0)
    rows, ctx, n = 300, 600, 1024
    x = torch.from_numpy(np.tanh(rng.standard_normal((rows, ctx))).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((n, ctx)) / 25).astype(np.float32)).to(cuda)
    lib, outs = load_kernels(), {}
    for depth in (640, 704):
        xp = kc.pad_units(x, ctx, depth).to(BF16).contiguous()
        wp = kc.pad_units(w, ctx, depth).to(BF16).contiguous()
        out = torch.empty((rows, n), dtype=torch.float32, device=cuda)
        kc.check_launch(lib.inpaint_arnn_ctx_gemm(xp.data_ptr(), wp.data_ptr(), out.data_ptr(),
                                                  rows, depth, n, ak.ARNN_CTX_GROUP,
                                                  stream_ptr()), "gemm")
        pieces = torch.stack(split_bf16_pieces(kc.pad_units(x, ctx, depth))).contiguous()
        wpieces = torch.stack(split_bf16_pieces(kc.pad_units(w, ctx, depth))).contiguous()
        out32 = torch.empty((rows, n), dtype=torch.float32, device=cuda)
        kc.check_launch(lib.inpaint_arnn_ctx_gemm_f32(pieces.data_ptr(), wpieces.data_ptr(),
                                                      out32.data_ptr(), rows, depth, n,
                                                      stream_ptr()), "split gemm")
        torch.cuda.synchronize()
        outs[depth] = out, out32
    assert torch.equal(outs[640][0], outs[704][0]) and torch.equal(outs[640][1], outs[704][1])
    want = x.to(BF16).float() @ w.to(BF16).float().t()
    assert (outs[640][0] - want).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_k7_context_gemm_partials_track_the_float64_product(cuda):
    """The bf16 route's context projection GEMM at C 3,954 (JAX's widest
    bf16 context at H 256): in partials of ``ARNN_CTX_GROUP`` k-slabs added
    in rounded f32, its RMS error against the float64 product is at most
    cuBLAS f32's; the whole of K in one tensor-core accumulator (group 0)
    drifts toward zero, past twice cuBLAS's."""
    from inpaintnet_tpu_torch.ops.kernel_common import load_kernels, stream_ptr

    gen = torch.Generator(device=cuda).manual_seed(3954)
    rows, ctx, n = 2048, 3954, 1024
    depth = ak.arnn_ctx_width(ctx)
    x = torch.tanh(torch.randn((rows, ctx), generator=gen, device=cuda)).to(BF16)
    w = (torch.randn((n, ctx), generator=gen, device=cuda) / 64).to(BF16)
    exact = x.double() @ w.double().t()

    def rel_rms(got):
        return ((got.double() - exact).square().mean().sqrt()
                / exact.square().mean().sqrt()).item()
    xp, wp = kc.pad_units(x, ctx, depth).contiguous(), kc.pad_units(w, ctx, depth).contiguous()
    lib, err = load_kernels(), {}
    for group in (ak.ARNN_CTX_GROUP, 0):
        out = torch.empty((rows, n), dtype=torch.float32, device=cuda)
        kc.check_launch(lib.inpaint_arnn_ctx_gemm(xp.data_ptr(), wp.data_ptr(), out.data_ptr(),
                                                  rows, depth, n, group, stream_ptr()), "gemm")
        torch.cuda.synchronize()
        err[group] = rel_rms(out)
    cublas = rel_rms(x.float() @ w.float().t())
    assert err[ak.ARNN_CTX_GROUP] <= cublas, (err, cublas)
    assert err[0] > 2 * cublas, (err, cublas)
