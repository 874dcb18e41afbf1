"""The CUDA kernels against their plain versions on the card, at small
shapes with ragged row tiles. Needs an NVIDIA Hopper GPU and nvcc; skips
elsewhere. Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have.)
"""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import arnn_kernel, decode_kernel, encoder_kernel, kernel_common
from inpaintnet_tpu_torch.ops import gru_kernel as lk
from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
from inpaintnet_tpu_torch.ops.gru import gru_init
from inpaintnet_tpu_torch.ops.gru_trainfast import gru_layer_trainfast
from inpaintnet_tpu_torch.ops.kernel_common import cluster_sizes, split_bf16_pieces
from inpaintnet_tpu_torch.ops.linear import embedding_init, linear_init
from inpaintnet_tpu_torch.ops.lstm import lstm_stack_init
from inpaintnet_tpu_torch.ops.quantize import dequantize_h

pytestmark = pytest.mark.cuda

# kernel vs plain version on the card: both accumulate in f32 (no TF32);
# bf16 allows two ulps of |h| < 1 for a carry rounding flipped by order
ATOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tree(tree, device, dtype, rng, noise=0.1):
    if isinstance(tree, dict):
        return {k: _tree(v, device, dtype, rng, noise) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, device, dtype, rng, noise) for v in tree]
    noisy = tree + noise * rng.standard_normal(tree.shape).astype(np.float32)
    return torch.from_numpy(noisy).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden", [(37, 64), (5, 128)])
def test_encoder_kernel_matches_plain(cuda, dtype, batch, hidden):
    rng = np.random.default_rng(batch)
    gru = _tree(gru_init(rng, 10, hidden, 2, True), cuda, dtype, rng)
    table = _tree(embedding_init(rng, 61, 10)["table"], cuda, dtype, rng)
    tokens = torch.from_numpy(rng.integers(0, 61, (batch, 24)).astype(np.int32)).to(cuda)
    before = encoder_kernel.encoder_hn.launches
    h_k = encoder_kernel.encoder_hn(gru, table, tokens)
    h_p = encoder_kernel.encoder_hn_reference(gru, table, tokens)
    torch.cuda.synchronize()
    assert encoder_kernel.encoder_hn.launches == before + 1
    assert h_k.shape == (4, batch, hidden) and h_k.dtype == dtype
    torch.testing.assert_close(h_k.float(), h_p.float(), rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_encoder_training_mode_matches_plain(cuda, dtype, rate):
    """K1's training mode (the keep mask on layer 0's stores) against its
    plain version, over three chunks of 64 rows (the mask is read at the
    chunk's global rows) with a ragged last one; rate 0.3's 1 / 0.7 is
    inexact, so a multiplication by the reciprocal would show."""
    rng = np.random.default_rng(int(rate * 10))
    batch, hidden = 150, 64
    gru = _tree(gru_init(rng, 10, hidden, 2, True), cuda, dtype, rng)
    table = _tree(embedding_init(rng, 61, 10)["table"], cuda, dtype, rng)
    tokens = torch.from_numpy(rng.integers(0, 61, (batch, 24)).astype(np.int32)).to(cuda)
    keep = torch.from_numpy(rng.random((batch, 24, 2 * hidden)) >= rate).to(cuda)
    before = encoder_kernel.encoder_hn.launches
    h_k = encoder_kernel.encoder_hn(gru, table, tokens, max_chunk_rows=64, keep=keep, rate=rate)
    h_p = encoder_kernel.encoder_hn_reference(gru, table, tokens, keep, rate)
    h_inf = encoder_kernel.encoder_hn(gru, table, tokens)
    torch.cuda.synchronize()
    assert encoder_kernel.encoder_hn.launches == before + 2
    torch.testing.assert_close(h_k.float(), h_p.float(), rtol=0, atol=ATOL[dtype])
    # layer 0 is not dropped; layer 1 is
    torch.testing.assert_close(h_k[:2].float(), h_inf[:2].float(), rtol=0, atol=ATOL[dtype])
    assert (h_k[2:].float() - h_inf[2:].float()).abs().max() > 10 * ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_training_mode_drops_as_the_eager_route(cuda, monkeypatch, dtype):
    """At rate 0.3 (1 / 0.7 is inexact) K1's training mode drops layer 0's
    outputs bit for bit as ``apply_dropout`` does, the one dropout of the
    eager route its gradient is taken through and of the default route: the
    scratch that layer 1 reads after a call with the mask equals
    ``apply_dropout`` of the scratch after a call without one (layer 0 is
    the same computation in both). f32's scratch is three bf16 pieces per
    output, whose sum is the output exactly. In f32 the reciprocal's product
    differs from that on some elements."""
    from inpaintnet_tpu_torch.ops.distributions import apply_dropout

    rng = np.random.default_rng(31)
    batch, hidden, steps, rate = 70, 64, 24, 0.3
    gru = _tree(gru_init(rng, 10, hidden, 2, True), cuda, dtype, rng)
    table = _tree(embedding_init(rng, 61, 10)["table"], cuda, dtype, rng)
    tokens = torch.from_numpy(rng.integers(0, 61, (batch, steps)).astype(np.int32)).to(cuda)
    keep = torch.from_numpy(rng.random((batch, steps, 2 * hidden)) >= rate).to(cuda)
    scratch = []
    real = encoder_kernel._scratch
    monkeypatch.setattr(encoder_kernel, "_scratch",
                        lambda *a, **k: scratch.append(real(*a, **k)) or scratch[-1])
    encoder_kernel.encoder_hn(gru, table, tokens)
    encoder_kernel.encoder_hn(gru, table, tokens, keep=keep, rate=rate)
    torch.cuda.synchronize()
    n = steps * batch * 2 * hidden  # one chunk: (steps, rows, 2H) per piece

    def layer0(ys):
        if dtype == torch.bfloat16:
            return ys[:n].view(steps, batch, 2 * hidden)
        pieces = ys[:3 * n].view(3, steps, batch, 2 * hidden).float()
        return (pieces[0] + pieces[1]) + pieces[2]

    y, got = layer0(scratch[0][0]), layer0(scratch[1][0])
    mask = keep.transpose(0, 1)
    assert torch.equal(got, apply_dropout(y, mask, rate))
    if dtype == torch.float32:
        assert not torch.equal(got, torch.where(mask, y * (1.0 / (1.0 - rate)), 0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,vocab", [(45, 64, 60), (7, 128, 13)])
def test_decode_kernel_matches_plain(cuda, dtype, batch, hidden, vocab):
    rng = np.random.default_rng(batch)
    params = _tree({
        "embedding": embedding_init(rng, vocab, 10),
        "x_0": np.zeros((10,), np.float32),
        "tick_gru": gru_init(rng, 10 + hidden, hidden, 2),
        "head": linear_init(rng, hidden, vocab),
    }, cuda, dtype, rng)
    tick_ctx = torch.from_numpy(rng.standard_normal((batch, 4, hidden)).astype(np.float32))
    h_inits = torch.from_numpy(rng.standard_normal((2, batch, 4, hidden)).astype(np.float32))
    tick_ctx, h_inits = (t.to(device=cuda, dtype=dtype) for t in (tick_ctx, h_inits))
    lg_k, s_k = decode_kernel.decode_sampling(params, tick_ctx, h_inits)
    lg_p, s_p = decode_kernel.decode_sampling_reference(params, tick_ctx, h_inits)
    torch.cuda.synchronize()
    assert lg_k.shape == (batch, 24, vocab) and s_k.dtype == torch.int32
    assert (s_k == s_p).float().mean().item() >= 0.99
    same_rows = (s_k == s_p).all(dim=1)
    torch.testing.assert_close(lg_k[same_rows].float(), lg_p[same_rows].float(), rtol=0,
                               atol=ATOL[dtype] * 4)


def _decode_case(rng, batch, hidden, vocab, dtype, device, big_row=None):
    params = _tree({
        "embedding": embedding_init(rng, vocab, 10),
        "x_0": np.zeros((10,), np.float32),
        "tick_gru": gru_init(rng, 10 + hidden, hidden, 2),
        "head": linear_init(rng, hidden, vocab),
    }, device, dtype, rng)
    tick_ctx = rng.standard_normal((batch, 4, hidden)).astype(np.float32)
    h_inits = rng.standard_normal((2, batch, 4, hidden)).astype(np.float32)
    if big_row is not None:  # a row whose init hiddens reach far above 1
        h_inits[:, big_row] *= 40.0
    return params, *(torch.from_numpy(t).to(device=device, dtype=dtype)
                     for t in (tick_ctx, h_inits))


def _with_cluster(monkeypatch, module, cluster):
    """``module.launch_plan`` (K8's or K2's) picks ``cluster`` CTAs a tile."""
    real = module.launch_plan
    monkeypatch.setattr(module, "launch_plan",
                        lambda *shape: real(*shape)._replace(cluster=cluster))


def _bit_equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("batch,hidden,vocab", [
    (6, 512, 60), (45, 64, 60), (2048, 512, 60), (2100, 128, 13), (45, 128, 13), (6, 64, 13),
    (70, 512, 256), (45, 448, 97)])
def test_decode_kernel_bf16_every_cluster_size(cuda, monkeypatch, batch, hidden, vocab):
    """K2's Hopper route at each cluster size its width allows: within the
    plain version's bounds, and bit-equal across cluster sizes (a cluster
    only moves h between its CTAs, so any difference is a race)."""
    rng = np.random.default_rng(batch + hidden)
    params, tick_ctx, h_inits = _decode_case(rng, batch, hidden, vocab, torch.bfloat16, cuda)
    outs = {}
    for cluster in cluster_sizes(hidden):
        with monkeypatch.context() as m:
            _with_cluster(m, decode_kernel, cluster)
            before = decode_kernel.decode_sampling.launches
            outs[cluster] = decode_kernel.decode_sampling(params, tick_ctx, h_inits)
            assert decode_kernel.decode_sampling.launches == before + 1
    lg_p, s_p = decode_kernel.decode_sampling_reference(params, tick_ctx, h_inits)
    torch.cuda.synchronize()
    lg_k, s_k = outs[cluster_sizes(hidden)[0]]
    assert all(_bit_equal(o, (lg_k, s_k)) for o in outs.values())
    assert (s_k == s_p).float().mean().item() >= 0.99
    same_rows = (s_k == s_p).all(dim=1)
    torch.testing.assert_close(lg_k[same_rows].float(), lg_p[same_rows].float(), rtol=0,
                               atol=ATOL[torch.bfloat16] * 4)


def _with_f32_cluster(monkeypatch, cluster):
    """K2's f32 plan picks ``cluster`` CTAs a tile (with that size's ring)."""
    monkeypatch.setattr(decode_kernel, "f32_plan", lambda rows, hidden, sms, slots=None:
                        decode_kernel.LaunchPlan(cluster,
                                                 decode_kernel.f32_stages(hidden, cluster)))


@pytest.mark.parametrize("batch,hidden,vocab", [
    (6, 512, 60), (2048, 512, 60), (45, 64, 60), (130, 128, 13), (7, 128, 96), (70, 512, 256)])
def test_decode_kernel_f32_every_cluster_size(cuda, monkeypatch, batch, hidden, vocab):
    """K2's f32 route (split products, h's pieces through L2) at each
    cluster size its width allows: within ``decode_kernel.F32_BOUNDS`` of
    the plain version, and bit-equal across cluster sizes (the race check:
    every size sums alike)."""
    rng = np.random.default_rng(batch + hidden + vocab)
    params, tick_ctx, h_inits = _decode_case(rng, batch, hidden, vocab, torch.float32, cuda)
    outs = {}
    for cluster in decode_kernel.f32_cluster_sizes(hidden):
        with monkeypatch.context() as m:
            _with_f32_cluster(m, cluster)
            before = decode_kernel.decode_sampling.launches
            outs[cluster] = decode_kernel.decode_sampling(params, tick_ctx, h_inits)
            assert decode_kernel.decode_sampling.launches == before + 1
    want = decode_kernel.decode_sampling_reference(params, tick_ctx, h_inits)
    torch.cuda.synchronize()
    got = outs[decode_kernel.f32_cluster_sizes(hidden)[0]]
    assert len(outs) >= 2 and all(_bit_equal(o, got) for o in outs.values())
    assert got[0].shape == (batch, 24, vocab) and got[1].dtype == torch.int32
    agree = decode_kernel.agreement(got, want)
    assert decode_kernel.within(agree), agree


def test_decode_kernel_f32_bounds_reject_planted_faults(cuda, monkeypatch):
    """K2 f32's traps, planted in the plain version: the products on h
    taken as one bf16 piece, and a reset tick whose products take the
    previous tick's h, break ``F32_BOUNDS``; layer 1's x- and h-products
    summed in one accumulator moves layer 1 by a rounding only, so it is
    held on cancelling biases (``cancelling_layer1_biases``), where its
    mean logit error must be ``SUM_ORDER_RATIO`` times the kernel's."""
    rng = np.random.default_rng(3)
    params, tick_ctx, h_inits = _decode_case(rng, 130, 128, 60, torch.float32, cuda)
    got = decode_kernel.decode_sampling(params, tick_ctx, h_inits)
    assert decode_kernel.within(decode_kernel.agreement(
        got, decode_kernel.decode_sampling_reference(params, tick_ctx, h_inits)))
    for hook, fault in (("tick_product",
                         lambda h, w: split_bf16_pieces(h)[0].float() @ w),
                        ("beat_operand", lambda init, prev: prev)):
        with monkeypatch.context() as m:
            m.setattr(decode_kernel, hook, fault)
            planted = decode_kernel.decode_sampling_reference(params, tick_ctx, h_inits)
        agree = decode_kernel.agreement(got, planted)
        assert not decode_kernel.within(agree), (hook, agree)
    args = (decode_kernel.cancelling_layer1_biases(params, decode_kernel.SUM_ORDER_SHIFT),
            tick_ctx, h_inits)
    plain = decode_kernel.decode_sampling_reference(*args)
    kernel = decode_kernel.agreement(decode_kernel.decode_sampling(*args), plain)
    monkeypatch.setattr(decode_kernel, "layer1_preacts", decode_kernel.one_accumulator_preacts)
    fault = decode_kernel.agreement(decode_kernel.decode_sampling_reference(*args), plain)
    assert fault["mean"] > decode_kernel.SUM_ORDER_RATIO * kernel["mean"], (kernel, fault)


# int8 kernel vs plain version: bit-equal. Both take exact int32 products,
# and the kernel rounds every f32 multiply and add, and every exp and tanh,
# as the plain version's PyTorch CUDA ops do (gru_common.cuh gru_gate), so
# nothing is left to differ.


def _encoder_int8_case(rng, batch, hidden, dtype, device, noise=0.1):
    gru = _tree(gru_init(rng, 10, hidden, 2, True), device, dtype, rng, noise)
    table = _tree(embedding_init(rng, 61, 10)["table"], device, dtype, rng)
    tokens = torch.from_numpy(rng.integers(0, 61, (batch, 24)).astype(np.int32)).to(device)
    return gru, table, tokens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden", [(37, 64), (5, 128)])
def test_encoder_int8_kernel_matches_plain(cuda, dtype, batch, hidden):
    gru, table, tokens = _encoder_int8_case(np.random.default_rng(batch), batch, hidden,
                                            dtype, cuda)
    before = encoder_kernel.encoder_hn_int8.launches
    h_k = encoder_kernel.encoder_hn_int8(gru, table, tokens)
    h_p = encoder_kernel.encoder_hn_int8_reference(gru, table, tokens)
    torch.cuda.synchronize()
    assert encoder_kernel.encoder_hn_int8.launches == before + 1
    assert h_k.shape == (4, batch, hidden) and h_k.dtype == dtype
    assert torch.equal(h_k, h_p)


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("rows,hidden", [(888, 64), (120, 128), (1000, 512)])
def test_encoder_projection_gemm_matches_plain(cuda, kind, rows, hidden):
    """The Hopper route's layer-1 GEMM alone, at ragged M (not a multiple of
    its 128-row tile): bf16 operands summed in f32 within 1e-5 relative
    (only the order of the f32 sums differs), int8 sums equal; f32 operands
    (the split GEMM: six passes over their bf16 pieces a k-slab) within 64
    x 2^-24 of the sum of |terms|: the tensor cores' own sums inside each
    slab are not rounded to nearest (seen 1.3e-5 at H 512 on values near
    2), and h taken as one bf16 piece would be 2^-9 off."""
    rng = np.random.default_rng(rows + hidden)
    if kind == "f32":
        ys = torch.from_numpy(rng.uniform(-1, 1, (rows, 2 * hidden)).astype(np.float32)).to(cuda)
        w = torch.from_numpy((0.1 * rng.standard_normal((2, 2 * hidden, 3 * hidden)))
                             .astype(np.float32)).to(cuda)
        b = torch.from_numpy(rng.standard_normal((2, 3 * hidden)).astype(np.float32)).to(cuda)
        got = encoder_kernel.input_projection(ys, w, b)
        want = encoder_kernel.input_projection_reference(ys, w, b)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (2, rows, 3 * hidden)
        scale = ys.double().abs() @ w.double().abs()
        assert ((got.double() - want.double()).abs() <= 64 * 2.0 ** -24 * scale).all()
    elif kind == "bf16":
        ys = torch.from_numpy(rng.uniform(-1, 1, (rows, 2 * hidden)).astype(np.float32))
        w = torch.from_numpy((0.1 * rng.standard_normal((2, 2 * hidden, 3 * hidden)))
                             .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, 3 * hidden)).astype(np.float32)).to(cuda)
        ys, w = ys.to(cuda, torch.bfloat16), w.to(cuda, torch.bfloat16)
        got = encoder_kernel.input_projection(ys, w, b)
        want = encoder_kernel.input_projection_reference(ys, w, b)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (2, rows, 3 * hidden)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        ys, w = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(cuda)
                 for shape in ((rows, 2 * hidden), (2, 2 * hidden, 3 * hidden)))
        got = encoder_kernel.input_projection_int8(ys, w)
        want = encoder_kernel.input_projection_int8_reference(ys, w)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (2, rows, 3 * hidden)
        assert torch.equal(got, want.int())


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("batch,hidden,chunk", [(150, 64, 64), (77, 128, 32), (70, 512, 64)])
def test_encoder_kernels_chunked_ragged_rows(cuda, kind, batch, hidden, chunk):
    """K1's routes and K3 over several row chunks (a small chunk cap
    forced), the last chunk and the last row tile ragged: the same h_n as
    the plain version, within the dtype's bound or bit-equal. The weights' noise
    shrinks as 1 / sqrt(H), as their init does: at H 512 a noise of 0.1
    makes the recurrence chaotic enough that two plain versions summing in
    another order already differ by more than two bf16 ulps."""
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    gru, table, tokens = _encoder_int8_case(np.random.default_rng(batch), batch, hidden,
                                            dtype, cuda, noise=0.8 / hidden ** 0.5)
    assert encoder_kernel.encoder_chunk_rows(batch, 24, hidden, chunk, dtype) == chunk < batch
    if kind == "f32":
        h_k = encoder_kernel.encoder_hn(gru, table, tokens, max_chunk_rows=chunk)
        h_p = encoder_kernel.encoder_hn_reference(gru, table, tokens)
        torch.cuda.synchronize()
        torch.testing.assert_close(h_k, h_p, rtol=0, atol=ATOL[torch.float32])
    elif kind == "bf16":
        h_k = encoder_kernel.encoder_hn(gru, table, tokens, max_chunk_rows=chunk)
        h_p = encoder_kernel.encoder_hn_reference(gru, table, tokens)
        torch.cuda.synchronize()
        torch.testing.assert_close(h_k.float(), h_p.float(), rtol=0,
                                   atol=ATOL[torch.bfloat16])
    else:
        h_k = encoder_kernel.encoder_hn_int8(gru, table, tokens, max_chunk_rows=chunk)
        h_p = encoder_kernel.encoder_hn_int8_reference(gru, table, tokens)
        torch.cuda.synchronize()
        assert torch.equal(h_k, h_p)


# K1's f32 h_n against its plain version: chip_smoke.py's f32 bound
K1_F32_HN = 1e-6


@pytest.mark.parametrize("batch,hidden", [(70, 64), (130, 128), (300, 512)])
def test_encoder_f32_within_the_f32_bound(cuda, batch, hidden):
    """K1's f32 route at the layers' own initialisation (the flagship's),
    at the one cluster size of each width (H / 64 CTAs of 64 units: the
    f32 recurrence's sum and k-slab partial fill a warpgroup's registers at
    32 units), within chip_smoke.py's f32 bound of h_n."""
    gru, table, tokens = _encoder_int8_case(np.random.default_rng(hidden), batch, hidden,
                                            torch.float32, cuda, noise=0.0)
    assert gk.fwd_cluster_sizes(hidden, torch.float32) == [hidden // 64]
    h_k = encoder_kernel.encoder_hn(gru, table, tokens)
    h_p = encoder_kernel.encoder_hn_reference(gru, table, tokens)
    torch.cuda.synchronize()
    assert (h_k - h_p).abs().max().item() <= K1_F32_HN


def test_encoder_f32_bound_rejects_planted_faults(cuda, monkeypatch):
    """K1 f32 against its plain versions with a planted fault: the product
    on h taken as one bf16 piece, and layer 1's projection rounded to bf16
    (the staged plain version), each beyond the f32 bound."""
    gru, table, tokens = _encoder_int8_case(np.random.default_rng(5), 130, 128, torch.float32,
                                            cuda, noise=0.0)
    got = encoder_kernel.encoder_hn(gru, table, tokens)
    monkeypatch.setattr(encoder_kernel, "recurrent_product",
                        lambda h, w: h.bfloat16().float() @ w)
    one_piece = encoder_kernel.encoder_hn_reference(gru, table, tokens)
    monkeypatch.undo()
    exact = encoder_kernel.input_projection_reference
    monkeypatch.setattr(encoder_kernel, "input_projection_reference",
                        lambda ys, w, b: exact(ys, w, b).bfloat16().float())
    rounded = encoder_kernel.encoder_hn_staged_reference(gru, table, tokens)
    torch.cuda.synchronize()
    for planted in (one_piece, rounded):
        assert (got - planted).abs().max().item() > K1_F32_HN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,vocab", [(45, 64, 60), (7, 128, 13)])
def test_decode_int8_kernel_matches_plain(cuda, dtype, batch, hidden, vocab):
    rng = np.random.default_rng(batch)
    params, tick_ctx, h_inits = _decode_case(rng, batch, hidden, vocab, dtype, cuda,
                                             big_row=batch // 2)
    before = decode_kernel.decode_sampling_int8.launches
    lg_k, s_k = decode_kernel.decode_sampling_int8(params, tick_ctx, h_inits)
    lg_p, s_p = decode_kernel.decode_sampling_int8_reference(params, tick_ctx, h_inits)
    torch.cuda.synchronize()
    assert decode_kernel.decode_sampling_int8.launches == before + 1
    assert lg_k.shape == (batch, 24, vocab) and s_k.dtype == torch.int32
    assert torch.equal(s_k, s_p) and torch.equal(lg_k, lg_p)


def test_int8_exact_bounds_reject_planted_faults(cuda, monkeypatch):
    """The traps, planted in the plain versions, differ from the kernels:
    an h_n taken from the dequantized int8 carry, and a fed-back token
    projection that skips its rounding to bf16."""
    gru, table, tokens = _encoder_int8_case(np.random.default_rng(37), 37, 64,
                                            torch.bfloat16, cuda)
    h_k = encoder_kernel.encoder_hn_int8(gru, table, tokens)
    _, ys = encoder_kernel.encoder_int8_layers_reference(gru, table, tokens)
    planted = torch.stack([dequantize_h(ys[0, -1]), dequantize_h(ys[1, 0])]).to(h_k.dtype)
    assert not torch.equal(h_k[:2], planted)

    params, tick_ctx, h_inits = _decode_case(np.random.default_rng(45), 45, 64, 60,
                                             torch.bfloat16, cuda, big_row=22)
    lg_k, s_k = decode_kernel.decode_sampling_int8(params, tick_ctx, h_inits)
    monkeypatch.setattr(decode_kernel, "fed_back_xw",
                        lambda ops, tok, dtype: ops["tok_q"][tok].float() * ops["scales"][3])
    lg_p, s_p = decode_kernel.decode_sampling_int8_reference(params, tick_ctx, h_inits)
    torch.cuda.synchronize()
    assert not (torch.equal(s_k, s_p) and torch.equal(lg_k, lg_p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,vocab", [
    (6, 512, 60), (2048, 512, 60), (130, 128, 13), (70, 256, 96), (45, 192, 60),
    (70, 512, 256), (45, 448, 97)])
def test_decode_int8_kernel_every_cluster_size(cuda, monkeypatch, dtype, batch, hidden, vocab):
    """K4's Hopper route on both master dtypes at each cluster size its width
    allows: bit-equal to the plain version, and so to each other (a cluster
    only moves h between its CTAs); one whole 96-column head chunk at H 256,
    two and three chunks at H 448 and 512."""
    rng = np.random.default_rng(batch + hidden + vocab)
    params, tick_ctx, h_inits = _decode_case(rng, batch, hidden, vocab, dtype, cuda,
                                             big_row=batch // 3)
    want = decode_kernel.decode_sampling_int8_reference(params, tick_ctx, h_inits)
    for cluster in cluster_sizes(hidden):
        with monkeypatch.context() as m:
            real = decode_kernel.int8_plan
            m.setattr(decode_kernel, "int8_plan",
                      lambda *shape, c=cluster: real(*shape)._replace(cluster=c))
            before = decode_kernel.decode_sampling_int8.launches
            got = decode_kernel.decode_sampling_int8(params, tick_ctx, h_inits)
            assert decode_kernel.decode_sampling_int8.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), cluster


# K2 bf16 with the weights of _decode_case (the layers' initialisation plus
# noise 0.1) at 512 rows x H 512, against its plain version
# (``arnn_kernel.decode_agreement``, the early share over the first beat's 6
# ticks). The mean and the early share lie between the readings of the
# kernel that sums layer 1 as the plain version does and of the kernel that
# summed its r/z x- and h-products in one accumulator, both on these inputs
# (``chip_smoke.py --parent``), seen on an NVIDIA H100 80GB HBM3 (700 W):
# mean 1.040e-4 against 1.199e-4, early 0.0228 against 0.0258; max
# 3.125e-2 (one bf16 ulp of the largest logits) in both (PERF.md).
K2_NOISY_BOUNDS = {"mean": 1.12e-4, "max": 3.125e-2, "early": 0.0243}


def test_decode_kernel_bf16_noisy_layer1_sum_order(cuda):
    rng = np.random.default_rng(91)
    params, tick_ctx, h_inits = _decode_case(rng, 512, 512, 60, torch.bfloat16, cuda)
    got = decode_kernel.decode_sampling(params, tick_ctx, h_inits)
    want = decode_kernel.decode_sampling_reference(params, tick_ctx, h_inits)
    unforced = torch.zeros((512, 24), dtype=torch.int32, device=cuda)
    a = arnn_kernel.decode_agreement(got, want, unforced, early_ticks=6)
    b = K2_NOISY_BOUNDS
    assert (a["logits_mean"] <= b["mean"] and a["logits_max"] <= b["max"]
            and a["early_changed"] <= b["early"]), a


def _tied_head(params, key, width, col=5):
    """``params`` with head column ``col`` copied into the next chunk (``col
    + width``) and both biases raised by 8: their equal logits are every
    tick's maximum."""
    head = dict(params[key])
    w, b = head["w"].clone(), head["b"].clone()
    w[:, col + width] = w[:, col]
    b[col] += 8.0
    b[col + width] = b[col]
    return {**params, key: {**head, "w": w, "b": b}}


@pytest.fixture
def later_chunk_wins_ties(monkeypatch):
    """The heads' planted fault: a later chunk wins a tie
    (``kernel_common.head_ties``)."""
    def plant():
        monkeypatch.setattr(kernel_common, "head_ties", lambda: 1)
    return plant


@pytest.mark.parametrize("kernel", ["k2", "k4", "k7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_take_the_first_index_across_chunks(cuda, later_chunk_wins_ties, kernel, dtype):
    """A head whose maximum ties across a chunk border: every kernel takes
    the first column, as its plain version's argmax; the variant that lets
    the later chunk win the tie, planted in the wrapper, does not."""
    rng = np.random.default_rng(11)
    if kernel == "k7":
        args = _arnn_case(rng, 37, 64, 64, 24, 130, 12, dtype, cuda, noise=0.0)
        args = (_tied_head(args[0], "linear_output_notes", arnn_kernel.ARNN_OUT_COLS),
                *args[1:])
        run, plain = arnn_kernel.arnn_sampled_decode, arnn_kernel.arnn_sampled_decode_reference
    else:
        params, tick_ctx, h_inits = _decode_case(rng, 37, 64, 200, dtype, cuda)
        args = (_tied_head(params, "head", decode_kernel.HEAD_COLS), tick_ctx, h_inits)
        run, plain = ((decode_kernel.decode_sampling, decode_kernel.decode_sampling_reference)
                      if kernel == "k2" else (decode_kernel.decode_sampling_int8,
                                              decode_kernel.decode_sampling_int8_reference))
    want = plain(*args)[1]
    sampled = want if kernel != "k7" else want[args[3] == 0]
    assert (sampled == 5).all()
    assert torch.equal(run(*args)[1], want)
    later_chunk_wins_ties()
    got = run(*args)[1]
    torch.cuda.synchronize()
    assert not torch.equal(got, want)
    assert ((got if kernel != "k7" else got[args[3] == 0]) == 5 + (
        arnn_kernel.ARNN_OUT_COLS if kernel == "k7" else decode_kernel.HEAD_COLS)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_int8_rows_independent_of_extreme_cobatched_row(cuda, dtype):
    """The per-row bound: a co-batched row with init hiddens far above 1
    leaves every other row's K4 tokens and logits bit-equal to its solo run."""
    rng = np.random.default_rng(3)
    params, tick_ctx, h_inits = _decode_case(rng, 40, 64, 60, dtype, cuda, big_row=17)
    lg_all, s_all = decode_kernel.decode_sampling_int8(params, tick_ctx, h_inits)
    normal = [r for r in range(40) if r != 17]
    lg_solo, s_solo = decode_kernel.decode_sampling_int8(
        params, tick_ctx[normal].contiguous(), h_inits[:, normal].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(s_all[normal], s_solo)
    assert torch.equal(lg_all[normal], lg_solo)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(0)
    gru = _tree(gru_init(rng, 10, 64, 2, True), cuda, torch.bfloat16, rng)
    table = _tree(embedding_init(rng, 30, 10)["table"], cuda, torch.bfloat16, rng)
    tokens = torch.zeros((4, 24), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        encoder_kernel.encoder_hn(gru, table, tokens)
    with pytest.raises(ValueError, match="contiguous"):
        encoder_kernel.encoder_hn(gru, table, tokens.int().t().contiguous().t())
    with pytest.raises(ValueError, match="hidden size"):  # past bf16's 640 ceiling
        odd = _tree(gru_init(rng, 10, 704, 2, True), cuda, torch.bfloat16, rng)
        encoder_kernel.encoder_hn(odd, table, tokens.int())
    with pytest.raises(ValueError, match="hidden size"):  # past f32's 512
        wide = _tree(gru_init(rng, 10, 576, 2, True), cuda, torch.float32, rng)
        encoder_kernel.encoder_hn(wide, table.float(), tokens.int())
    with pytest.raises(ValueError, match="dtype"):
        encoder_kernel.encoder_hn_int8(gru, table, tokens)
    with pytest.raises(ValueError, match="hidden size"):
        encoder_kernel.encoder_hn_int8(odd, table, tokens.int())


# K5/K6 vs their plain versions on the card, as the (max, mean) over the
# outputs of |kernel - plain| / (1 + |plain|): absolute below 1, relative
# above, as the products' sums grow with H. f32: both accumulate in true f32
# and differ in summation order only (seen at H 128: 1.3e-6 and 6e-7).
# bf16: the outputs are stored in bf16, so an f32 last bit may flip one
# output's rounding (one ulp, 3.9e-3 of the value), and such flips are rare
# (the mean bound, as chip_smoke.py's: a flip in K5's bf16 copy of the
# carry cascades along its row). A K5 carry rounded to bf16, or a K6
# product on dhw rounded to bf16, moves the mean by 1e-4 or more.
TRAIN_BOUNDS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 5e-5)}


def _train_case(rng, batch, hidden, seq_len, dtype, device):
    fwd = [(0.3 * rng.standard_normal((hidden, 3 * hidden))),
           (0.1 * rng.standard_normal(3 * hidden)),
           rng.standard_normal((batch, seq_len, 3 * hidden)),
           (0.5 * rng.standard_normal((batch, hidden)))]
    dys = rng.standard_normal((seq_len, batch, hidden))
    hprev = 0.5 * rng.standard_normal((seq_len, batch, hidden))
    return ([torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype) for a in fwd],
            *(torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
              for a in (dys, hprev)))


def _errs(a, b):
    d = [(x.float() - y.float()).abs() / (1.0 + y.float().abs()) for x, y in zip(a, b)]
    return max(x.max().item() for x in d), max(x.mean().item() for x in d)


def _run_train_kernels(fwd, dys, hprev, reverse, kernel: bool):
    f = gk.gru_fwd_seq if kernel else gk.gru_fwd_seq_reference
    b = gk.gru_bwd_seq if kernel else gk.gru_bwd_seq_reference
    out = f(*fwd, reverse=reverse)
    return out, b(fwd[0], dys, *out[1:], hprev, reverse=reverse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,seq_len,reverse",
                         [(37, 64, 24, False), (37, 64, 24, True), (5, 128, 6, False)])
def test_train_kernels_match_plain(cuda, dtype, batch, hidden, seq_len, reverse):
    fwd, dys, hprev = _train_case(np.random.default_rng(batch + hidden), batch, hidden,
                                  seq_len, dtype, cuda)
    before = (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches)
    out_k, grads_k = _run_train_kernels(fwd, dys, hprev, reverse, kernel=True)
    out_p, grads_p = _run_train_kernels(fwd, dys, hprev, reverse, kernel=False)
    torch.cuda.synchronize()
    assert (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches) == (before[0] + 1, before[1] + 1)
    assert all(o.shape == (seq_len, batch, hidden) and o.dtype == dtype for o in out_k)
    assert grads_k[0].shape == (seq_len, batch, 3 * hidden) and grads_k[2].shape == (batch, hidden)
    max_b, mean_b = TRAIN_BOUNDS[dtype]
    for got, want in ((out_k, out_p), (grads_k, grads_p)):
        err_max, err_mean = _errs(got, want)
        assert err_max <= max_b and err_mean <= mean_b, (err_max, err_mean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_kernel_bounds_reject_planted_faults(cuda, monkeypatch, dtype):
    fwd, dys, hprev = _train_case(np.random.default_rng(0), 37, 64, 24, dtype, cuda)
    out_k, grads_k = _run_train_kernels(fwd, dys, hprev, False, kernel=True)
    monkeypatch.setattr(gk, "fwd_carry", lambda h: h.to(torch.bfloat16).float())
    out_p = gk.gru_fwd_seq_reference(*fwd)
    monkeypatch.undo()
    monkeypatch.setattr(gk, "bwd_product", lambda d, w_t: d.to(torch.bfloat16).float() @ w_t)
    grads_p = gk.gru_bwd_seq_reference(fwd[0], dys, *out_k[1:], hprev)
    torch.cuda.synchronize()
    max_b, mean_b = TRAIN_BOUNDS[dtype]
    for got, want in ((out_k, out_p), (grads_k, grads_p)):
        err_max, err_mean = _errs(got, want)
        assert err_max > max_b or err_mean > mean_b, (err_max, err_mean)


def _with_bwd_cluster(monkeypatch, cluster):
    """K6's ``bwd_plan`` picks ``cluster`` CTAs a tile."""
    monkeypatch.setattr(gk, "bwd_plan", lambda hidden, dtype: gk.LaunchPlan(
        cluster, gk.bwd_ring_stages(hidden // cluster, gk.bwd_weight_pieces(dtype))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,seq_len,reverse", [
    (130, 512, 3, False), (70, 128, 5, True), (37, 320, 4, False), (64, 384, 3, True)])
def test_gru_bwd_every_cluster_size(cuda, monkeypatch, dtype, batch, hidden, seq_len, reverse):
    """K6 at each cluster size its width and dtype allow (the scratch
    exchange of dhw's pieces across a cluster only moves data): bit-equal
    across sizes, which is the race check of the exchange, and within the
    plain version's bounds."""
    fwd, dys, hprev = _train_case(np.random.default_rng(batch + hidden), batch, hidden,
                                  seq_len, dtype, cuda)
    out = gk.gru_fwd_seq_reference(*fwd, reverse=reverse)
    want = gk.gru_bwd_seq_reference(fwd[0], dys, *out[1:], hprev, reverse=reverse)
    got = {}
    for cluster in gk.bwd_cluster_sizes(hidden, dtype):
        with monkeypatch.context() as m:
            _with_bwd_cluster(m, cluster)
            got[cluster] = gk.gru_bwd_seq(fwd[0], dys, *out[1:], hprev, reverse=reverse)
    torch.cuda.synchronize()
    first = next(iter(got.values()))
    assert all(_bit_equal(g, first) for g in got.values()), sorted(got)
    max_b, mean_b = TRAIN_BOUNDS[dtype]
    err_max, err_mean = _errs(first, want)
    assert err_max <= max_b and err_mean <= mean_b, (err_max, err_mean)


def _with_fwd_cluster(monkeypatch, cluster):
    """K5's ``fwd_plan`` picks ``cluster`` CTAs a tile."""
    monkeypatch.setattr(gk, "fwd_plan", lambda hidden, dtype: gk.LaunchPlan(
        cluster, gk.fwd_ring_stages(hidden // cluster, gk.bwd_weight_pieces(dtype))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,seq_len,reverse", [
    (130, 512, 3, False), (70, 128, 5, True), (37, 384, 4, False), (64, 320, 3, True)])
def test_gru_fwd_every_cluster_size(cuda, monkeypatch, dtype, batch, hidden, seq_len, reverse):
    """K5 at each cluster size its width and dtype allow (the scratch
    exchange of h's pieces across a cluster only moves data): bit-equal
    across sizes, which is the race check of the exchange, and within the
    plain version's bounds. W_hh at Xavier's scale: at _train_case's 0.3 a
    recurrence of H 320-512 is chaotic, and any other summation order than
    the plain version's leaves the bounds within a few steps."""
    fwd, _, _ = _train_case(np.random.default_rng(batch + hidden), batch, hidden, seq_len,
                            dtype, cuda)
    fwd[0] = (fwd[0].float() * ((2.0 / (4 * hidden)) ** 0.5 / 0.3)).to(dtype)
    want = gk.gru_fwd_seq_reference(*fwd, reverse=reverse)
    got = {}
    for cluster in gk.fwd_cluster_sizes(hidden, dtype):
        with monkeypatch.context() as m:
            _with_fwd_cluster(m, cluster)
            got[cluster] = gk.gru_fwd_seq(*fwd, reverse=reverse)
    torch.cuda.synchronize()
    first = next(iter(got.values()))
    assert all(_bit_equal(g, first) for g in got.values()), sorted(got)
    max_b, mean_b = TRAIN_BOUNDS[dtype]
    err_max, err_mean = _errs(first, want)
    assert err_max <= max_b and err_mean <= mean_b, (err_max, err_mean)


def test_gru_fwd_bounds_reject_a_one_piece_product(cuda, monkeypatch):
    """In f32, K5's product on h taken as one bf16 piece (against W's three),
    planted in the plain version, breaks the bounds."""
    fwd, _, _ = _train_case(np.random.default_rng(0), 37, 64, 24, torch.float32, cuda)
    out_k = gk.gru_fwd_seq(*fwd)
    monkeypatch.setattr(gk, "fwd_product", lambda h, w, dtype: h.to(torch.bfloat16).float() @ w)
    out_p = gk.gru_fwd_seq_reference(*fwd)
    torch.cuda.synchronize()
    max_b, mean_b = TRAIN_BOUNDS[torch.float32]
    err_max, err_mean = _errs(out_k, out_p)
    assert err_max > max_b or err_mean > mean_b, (err_max, err_mean)


def test_gru_bwd_bounds_reject_dh_carried_in_bf16(cuda, monkeypatch):
    """In bf16, K6's dh carried in the parameter dtype between steps (a
    risk of any design that moves dh across CTAs), planted in the plain
    version, breaks the bounds."""
    fwd, dys, hprev = _train_case(np.random.default_rng(0), 37, 64, 24, torch.bfloat16, cuda)
    out_k, grads_k = _run_train_kernels(fwd, dys, hprev, False, kernel=True)
    monkeypatch.setattr(gk, "bwd_carry", lambda dh, dtype: dh.to(dtype).float())
    grads_p = gk.gru_bwd_seq_reference(fwd[0], dys, *out_k[1:], hprev)
    torch.cuda.synchronize()
    max_b, mean_b = TRAIN_BOUNDS[torch.bfloat16]
    err_max, err_mean = _errs(grads_k, grads_p)
    assert err_max > max_b or err_mean > mean_b, (err_max, err_mean)


@pytest.mark.parametrize("reverse", [False, True])
def test_trainfast_function_on_card_matches_cpu(cuda, reverse):
    """The autograd Function in f32: K5 and K6 on the card against the plain
    versions on the CPU, values and every gradient (the batched gradient
    products run on each device: 1e-4 allows their summation orders over
    the 24 x 37 rows). The CPU side runs on float64 inputs and is cast down
    for the comparison: its f32 products moved with the process's state
    from run to run, while the card's side is bit-identical."""
    rng = np.random.default_rng(5)
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in gru_init(rng, 20, 64, 1)[0][0].items()}
    x = rng.standard_normal((37, 24, 20)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((37, 64))).astype(np.float32)
    wy = rng.standard_normal((37, 24, 64)).astype(np.float32)

    def run(device, dtype=torch.float32):
        tp = {k: torch.from_numpy(v).to(device, dtype).requires_grad_() for k, v in p.items()}
        tx, th0 = (torch.from_numpy(a).to(device, dtype).requires_grad_() for a in (x, h0))
        ys, h_last = gru_layer_trainfast(tp, tx, th0, reverse=reverse)
        loss = (ys * torch.from_numpy(wy).to(device, dtype)).sum() + h_last.sum()
        loss.backward()
        return [loss.detach()] + [tp[k].grad for k in sorted(tp)] + [tx.grad, th0.grad]

    before = (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches)
    card = run(cuda)
    torch.cuda.synchronize()
    assert (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches) == (before[0] + 1, before[1] + 1)
    for got, want in zip(card, run("cpu", torch.float64)):
        torch.testing.assert_close(got.cpu(), want.float(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_trainfast_function_is_deterministic_on_card(cuda, reverse):
    """Two runs of the autograd Function on the card (K5, K6 and the
    batched gradient products) on the same inputs agree bit for bit, values
    and every gradient, however the caching allocator places their
    buffers."""
    rng = np.random.default_rng(5)
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in gru_init(rng, 20, 64, 1)[0][0].items()}
    x = rng.standard_normal((37, 24, 20)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((37, 64))).astype(np.float32)
    wy = torch.from_numpy(rng.standard_normal((37, 24, 64)).astype(np.float32)).to(cuda)

    def run(shift):
        pad = torch.empty(shift, device=cuda)  # another place for the buffers that follow
        tp = {k: torch.from_numpy(v).to(cuda).requires_grad_() for k, v in p.items()}
        tx, th0 = (torch.from_numpy(a).to(cuda).requires_grad_() for a in (x, h0))
        ys, h_last = gru_layer_trainfast(tp, tx, th0, reverse=reverse)
        loss = (ys * wy).sum() + h_last.sum()
        loss.backward()
        del pad
        return [ys.detach(), loss.detach()] + [tp[k].grad for k in sorted(tp)] + [tx.grad,
                                                                                   th0.grad]

    first = run(1)
    for shift in (4099, 65537):
        assert all(torch.equal(a, b) for a, b in zip(run(shift), first))


def test_train_wrappers_reject_what_the_kernels_do_not_take(cuda):
    fwd, dys, hprev = _train_case(np.random.default_rng(0), 8, 64, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        gk.gru_fwd_seq(*(t.half() for t in fwd))
    with pytest.raises(ValueError, match="contiguous"):
        gk.gru_fwd_seq(fwd[0], fwd[1], fwd[2].transpose(0, 1).contiguous().transpose(0, 1),
                       fwd[3])
    # above 1024 bf16 CTAs own 128 units: 1088 (17 blocks of 64) is the
    # trainfast Function's to pad, and the wrapper refuses it
    odd, _, _ = _train_case(np.random.default_rng(0), 8, 1088, 4, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="hidden size"):
        gk.gru_fwd_seq(*odd)
    out = gk.gru_fwd_seq(*fwd)
    with pytest.raises(ValueError, match="shape"):
        gk.gru_bwd_seq(fwd[0], dys[:, :4].contiguous(), *out[1:], hprev)


# K7 vs its plain version on the card (``arnn_kernel.decode_agreement``),
# seen on an NVIDIA H100 80GB HBM3 (700 W) at these shapes. f32: both
# accumulate in f32, in other orders (logits max 3.3e-7, mean 5e-8). bf16: an
# f32 last bit may flip a carry's or a logit's bf16 rounding (one ulp: max
# 2.0e-3, mean 1.4e-5), rarely (no logit of the first 8 ticks changed); a c
# carry kept in f32 changes 31-48% of those. A token may flip only on a
# near-tie of the logits, never at a forced tick (a force mask read one
# tick late: tie gaps 0.56 and 0.79).
K7_BOUNDS = {torch.float32: {"tokens": 0.99, "max": 1e-5, "mean": 1e-6},
             torch.bfloat16: {"tokens": 0.98, "max": 1e-2, "mean": 1e-4, "early": 0.15}}


def _arnn_case(rng, batch, hidden, ctx_dim, seq_len, vocab, linear, dtype, device, noise=0.1):
    emb = 10
    params = _tree({
        "note_embedding": embedding_init(rng, vocab + 1, emb),
        "lstm_generation": lstm_stack_init(rng, [(emb + ctx_dim, hidden), (hidden, hidden)]),
        "linear_1": linear_init(rng, hidden, linear),
        "linear_output_notes": linear_init(rng, linear, vocab),
    }, device, dtype, rng, noise)
    ctx = torch.from_numpy(np.tanh(rng.standard_normal((batch, seq_len, ctx_dim)))
                           .astype(np.float32)).to(device=device, dtype=dtype)
    score = torch.from_numpy(rng.integers(0, vocab, (batch, seq_len)).astype(np.int32)).to(device)
    force = torch.ones((batch, seq_len), dtype=torch.int32, device=device)
    force[:, seq_len // 3: 2 * seq_len // 3] = 0
    start = params["note_embedding"]["table"][vocab - 1:vocab].contiguous()
    return params, ctx, score, force, start


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,ctx_dim,vocab,linear", [(37, 64, 64, 60, 12),
                                                               (5, 128, 64, 13, 64)])
def test_arnn_kernel_matches_plain(cuda, dtype, batch, hidden, ctx_dim, vocab, linear):
    args = _arnn_case(np.random.default_rng(batch), batch, hidden, ctx_dim, 72, vocab, linear,
                      dtype, cuda)
    before = arnn_kernel.arnn_sampled_decode.launches
    got = arnn_kernel.arnn_sampled_decode(*args)
    want = arnn_kernel.arnn_sampled_decode_reference(*args)
    torch.cuda.synchronize()
    assert arnn_kernel.arnn_sampled_decode.launches == before + 1
    assert got[0].shape == (batch, 72, vocab) and got[0].dtype == dtype
    assert got[1].dtype == torch.int32
    force = args[3] > 0
    assert torch.equal(got[1][force], args[2][force])  # forced ticks carry the ground truth
    agree = arnn_kernel.decode_agreement(got, want, args[3])
    assert arnn_kernel.within(agree, K7_BOUNDS[dtype]), agree


def test_arnn_kernel_bounds_reject_planted_faults(cuda, monkeypatch):
    """In bf16: a c carry kept in f32, and a force mask read one tick late,
    planted in the plain version, break the bounds."""
    args = _arnn_case(np.random.default_rng(37), 37, 64, 64, 72, 60, 12, torch.bfloat16, cuda)
    got = arnn_kernel.arnn_sampled_decode(*args)
    monkeypatch.setattr(arnn_kernel, "carry_c", lambda c, dtype: c)
    carry = arnn_kernel.arnn_sampled_decode_reference(*args)
    monkeypatch.undo()
    force = args[3]
    late = arnn_kernel.arnn_sampled_decode_reference(
        *args[:3], torch.cat([force[:, :1], force[:, :-1]], dim=1), args[4])
    for planted in (carry, late):
        agree = arnn_kernel.decode_agreement(got, planted, force)
        assert not arnn_kernel.within(agree, K7_BOUNDS[torch.bfloat16]), agree


def _with_arnn_cluster(monkeypatch, cluster):
    """K7's ``arnn_plan`` picks ``cluster`` CTAs a tile."""
    real = arnn_kernel.arnn_plan
    monkeypatch.setattr(arnn_kernel, "arnn_plan", lambda rows, hidden, linear, sms, slots=None:
                        real(rows, hidden, linear, sms, slots)._replace(
                            cluster=cluster, stages=arnn_kernel.arnn_ring_stages(
                                hidden, cluster, arnn_kernel.arnn_hid_cols(
                                    hidden, cluster, arnn_kernel.arnn_head_width(linear)))))


@pytest.mark.parametrize("batch,hidden,ctx_dim,vocab,linear", [
    (70, 256, 256, 60, 256), (37, 128, 64, 13, 64), (5, 256, 128, 30, 200),
    (9, 256, 64, 40, 300), (9, 256, 64, 130, 1024)])
def test_arnn_kernel_bf16_every_cluster_size(cuda, monkeypatch, batch, hidden, ctx_dim, vocab,
                                             linear):
    """K7's bf16 route at each cluster size its width allows: bit-equal
    across sizes (the cluster only moves h between its CTAs; every CTA
    recomputes the head), and within the plain version's bounds. The
    weights are the layers' own initialisation, as the flagship's: with
    noise added, as K7_BOUNDS' H 64 cases have, the logits at H 256 grow
    and order flips of bf16 roundings move their mean past 1e-4 for the
    first kernel as for this one (seen 1.3e-4 at 0.05; PERF.md), so
    test_arnn_kernel_bf16_h256_noisy_no_worse_than_first_kernel holds
    those cases to the first kernel's error."""
    args = _arnn_case(np.random.default_rng(batch), batch, hidden, ctx_dim, 48, vocab, linear,
                      torch.bfloat16, cuda, noise=0.0)
    got = {}
    for cluster in arnn_kernel.arnn_cluster_sizes(hidden, arnn_kernel.arnn_head_width(linear)):
        with monkeypatch.context() as m:
            _with_arnn_cluster(m, cluster)
            got[cluster] = arnn_kernel.arnn_sampled_decode(*args)
    want = arnn_kernel.arnn_sampled_decode_reference(*args)
    torch.cuda.synchronize()
    first = next(iter(got.values()))
    assert len(got) > 1 and all(_bit_equal(g, first) for g in got.values()), sorted(got)
    agree = arnn_kernel.decode_agreement(first, want, args[3])
    assert arnn_kernel.within(agree, K7_BOUNDS[torch.bfloat16]), agree


def _first_kernel(args):
    """K7's call through the first kernel (``csrc/arnn_decode.cu``), which
    no route of the wrapper runs: the Hopper routes' yardstick."""
    return arnn_kernel._decode_tiled(*args, arnn_kernel._check_arnn_args(*args))


# K7's bf16 Hopper route at the flagship's H = C = L = 256 with noisy
# weights, whose larger logits make order flips of bf16 roundings show,
# held to the first kernel's error on the same inputs (both against the
# plain version): the max and mean logit errors at most
# K7_FIRST_KERNEL_RATIO times the first kernel's. The two sum alike, and
# their readings were seen equal here on an NVIDIA H100 80GB HBM3 (700 W).
K7_FIRST_KERNEL_RATIO = 1.1


@pytest.mark.parametrize("noise", [0.05, 0.1])
def test_arnn_kernel_bf16_h256_noisy_no_worse_than_first_kernel(cuda, monkeypatch, noise):
    """The Hopper route against the first kernel at H 256 with noise on the
    weights; a c carry kept in f32 and a context projection rounded to
    bf16, planted in the plain version, break the same bounds."""
    args = _arnn_case(np.random.default_rng(70), 70, 256, 256, 48, 60, 256, torch.bfloat16,
                      cuda, noise=noise)
    got = arnn_kernel.arnn_sampled_decode(*args)
    first = _first_kernel(args)
    want = arnn_kernel.arnn_sampled_decode_reference(*args)
    torch.cuda.synchronize()
    a_first = arnn_kernel.decode_agreement(first, want, args[3])
    bounds = {**K7_BOUNDS[torch.bfloat16],
              "max": K7_FIRST_KERNEL_RATIO * a_first["logits_max"],
              "mean": K7_FIRST_KERNEL_RATIO * a_first["logits_mean"]}
    agree = arnn_kernel.decode_agreement(got, want, args[3])
    assert arnn_kernel.within(agree, bounds), (agree, a_first)
    monkeypatch.setattr(arnn_kernel, "carry_c", lambda c, dtype: c)
    carry = arnn_kernel.arnn_sampled_decode_reference(*args)
    monkeypatch.undo()
    real = arnn_kernel.ctx_projection
    monkeypatch.setattr(arnn_kernel, "ctx_projection",
                        lambda ctx, w: real(ctx, w).to(torch.bfloat16).float())
    projection = arnn_kernel.arnn_sampled_decode_staged_reference(*args)
    for planted in (carry, projection):
        f_agree = arnn_kernel.decode_agreement(got, planted, args[3])
        assert not arnn_kernel.within(f_agree, bounds), (f_agree, bounds)


@pytest.mark.parametrize("batch,hidden,ctx_dim,vocab,linear", [
    (37, 512, 256, 60, 256), (20, 256, 256, 65, 256)])
def test_arnn_kernel_bf16_first_kernel_geometries(cuda, batch, hidden, ctx_dim, vocab, linear):
    """The bf16 geometries that ran the first kernel before the heads were
    chunked (H 512 at a 256-wide head, now a 128-column hidden tile in two
    rounds; a vocabulary over 64, now two output chunks) run the Hopper
    route: two CUDA launches a chunk, within the plain version's bounds
    (the layers' own initialisation, as the flagship's)."""
    assert arnn_kernel.arnn_hopper_supports(hidden, linear, vocab)
    assert arnn_kernel.arnn_cuda_launches(torch.bfloat16, batch, 48, hidden, linear, vocab) == 2
    args = _arnn_case(np.random.default_rng(batch), batch, hidden, ctx_dim, 48, vocab, linear,
                      torch.bfloat16, cuda, noise=0.0)
    before = arnn_kernel.arnn_sampled_decode.launches
    got = arnn_kernel.arnn_sampled_decode(*args)
    want = arnn_kernel.arnn_sampled_decode_reference(*args)
    torch.cuda.synchronize()
    assert arnn_kernel.arnn_sampled_decode.launches == before + 1
    force = args[3] > 0
    assert torch.equal(got[1][force], args[2][force])
    agree = arnn_kernel.decode_agreement(got, want, args[3])
    assert arnn_kernel.within(agree, K7_BOUNDS[torch.bfloat16]), agree


def test_arnn_kernel_bf16_chunked_rows(cuda, monkeypatch):
    """Chunks of 64 rows (each its own context GEMM and recurrence, the
    scratch cap lowered) give the same bits as one chunk."""
    args = _arnn_case(np.random.default_rng(3), 150, 128, 64, 24, 60, 64, torch.bfloat16, cuda)
    whole = arnn_kernel.arnn_sampled_decode(*args)
    monkeypatch.setattr(encoder_kernel, "XW_SCRATCH_BYTES", 64 * 24 * 4 * 128 * 4)
    assert arnn_kernel.arnn_chunk_rows(150, 24, 128) == 64
    chunked = arnn_kernel.arnn_sampled_decode(*args)
    torch.cuda.synchronize()
    assert _bit_equal(whole, chunked)


def test_arnn_kernel_bf16_rejects_a_bf16_context_projection(cuda, monkeypatch):
    """The staged plain version (the context projection of every tick taken
    first, in f32) is within the bounds; with the projection rounded to
    bf16, planted, it is not."""
    args = _arnn_case(np.random.default_rng(37), 37, 64, 64, 72, 60, 12, torch.bfloat16, cuda)
    got = arnn_kernel.arnn_sampled_decode(*args)
    staged = arnn_kernel.arnn_sampled_decode_staged_reference(*args)
    assert arnn_kernel.within(arnn_kernel.decode_agreement(got, staged, args[3]),
                              K7_BOUNDS[torch.bfloat16])
    real = arnn_kernel.ctx_projection
    monkeypatch.setattr(arnn_kernel, "ctx_projection",
                        lambda ctx, w: real(ctx, w).to(torch.bfloat16).float())
    planted = arnn_kernel.arnn_sampled_decode_staged_reference(*args)
    agree = arnn_kernel.decode_agreement(got, planted, args[3])
    assert not arnn_kernel.within(agree, K7_BOUNDS[torch.bfloat16]), agree


@pytest.mark.parametrize("batch,hidden,ctx_dim,vocab,linear", [
    (70, 256, 256, 60, 256), (37, 64, 64, 60, 12), (5, 128, 64, 13, 64), (9, 512, 64, 40, 300),
    (9, 256, 64, 130, 600)])
def test_arnn_kernel_f32_every_cluster_size(cuda, monkeypatch, batch, hidden, ctx_dim, vocab,
                                            linear):
    """K7's f32 route at each cluster size its width allows, the flagship's
    H 256 (2, 4, 8) and H 64 (1, 2) among them: bit-equal across sizes (the
    cluster only moves the h and hidden pieces through L2; every CTA
    computes the logits), two CUDA launches a chunk, and within the plain
    version's f32 bounds (the layers' own initialisation)."""
    args = _arnn_case(np.random.default_rng(batch), batch, hidden, ctx_dim, 48, vocab, linear,
                      torch.float32, cuda, noise=0.0)
    assert arnn_kernel.arnn_cuda_launches(torch.float32, batch, 48, hidden, linear, vocab) == 2
    got = {}
    real = arnn_kernel.arnn_f32_plan
    for cluster in arnn_kernel.arnn_f32_cluster_sizes(hidden, arnn_kernel.arnn_head_width(linear)):
        with monkeypatch.context() as m:
            m.setattr(arnn_kernel, "arnn_f32_plan", lambda *shape, c=cluster:
                      real(*shape)._replace(cluster=c))
            got[cluster] = arnn_kernel.arnn_sampled_decode(*args)
    want = arnn_kernel.arnn_sampled_decode_reference(*args)
    torch.cuda.synchronize()
    first = next(iter(got.values()))
    assert len(got) > 1 and all(_bit_equal(g, first) for g in got.values()), sorted(got)
    agree = arnn_kernel.decode_agreement(first, want, args[3])
    assert arnn_kernel.within(agree, K7_BOUNDS[torch.float32]), agree


def test_arnn_kernel_f32_bounds_reject_planted_faults(cuda, monkeypatch):
    """In f32: the products on h taken as one bf16 piece (the plain
    version) and the context projection rounded to bf16 (the staged plain
    version), planted, break the bounds the kernel holds."""
    args = _arnn_case(np.random.default_rng(37), 37, 64, 64, 72, 60, 12, torch.float32, cuda)
    got = arnn_kernel.arnn_sampled_decode(*args)
    staged = arnn_kernel.arnn_sampled_decode_staged_reference(*args)
    assert arnn_kernel.within(arnn_kernel.decode_agreement(got, staged, args[3]),
                              K7_BOUNDS[torch.float32])
    monkeypatch.setattr(arnn_kernel, "recurrent_product", lambda h, w: h.bfloat16().float() @ w)
    one_piece = arnn_kernel.arnn_sampled_decode_reference(*args)
    monkeypatch.undo()
    real = arnn_kernel.ctx_projection
    monkeypatch.setattr(arnn_kernel, "ctx_projection",
                        lambda ctx, w: real(ctx, w).to(torch.bfloat16).float())
    projection = arnn_kernel.arnn_sampled_decode_staged_reference(*args)
    for planted in (one_piece, projection):
        agree = arnn_kernel.decode_agreement(got, planted, args[3])
        assert not arnn_kernel.within(agree, K7_BOUNDS[torch.float32]), agree


def test_arnn_kernel_f32_first_kernel_geometry_and_chunks(cuda, monkeypatch):
    """A vocabulary over 64, the first kernel's in f32 before the heads were
    chunked, runs the split route (two CUDA launches), within the bounds;
    the split route over chunks of 64 rows gives the same bits as one
    chunk."""
    assert arnn_kernel.arnn_f32_supports(256, 256, 65)
    assert arnn_kernel.arnn_cuda_launches(torch.float32, 20, 48, 256, 256, 65) == 2
    args = _arnn_case(np.random.default_rng(20), 20, 256, 256, 48, 65, 256, torch.float32, cuda,
                      noise=0.0)
    agree = arnn_kernel.decode_agreement(arnn_kernel.arnn_sampled_decode(*args),
                                         arnn_kernel.arnn_sampled_decode_reference(*args), args[3])
    assert arnn_kernel.within(agree, K7_BOUNDS[torch.float32]), agree
    args = _arnn_case(np.random.default_rng(3), 150, 128, 64, 24, 60, 64, torch.float32, cuda)
    whole = arnn_kernel.arnn_sampled_decode(*args)
    monkeypatch.setattr(encoder_kernel, "XW_SCRATCH_BYTES", 64 * 24 * 4 * 128 * 4)
    assert arnn_kernel.arnn_chunk_rows(150, 24, 128) == 64
    chunked = arnn_kernel.arnn_sampled_decode(*args)
    torch.cuda.synchronize()
    assert _bit_equal(whole, chunked)


def test_arnn_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(0)
    params, ctx, score, force, start = _arnn_case(rng, 4, 64, 64, 8, 30, 12, torch.float32,
                                                  cuda)
    with pytest.raises(ValueError, match="dtype"):
        arnn_kernel.arnn_sampled_decode(params, ctx, score.long(), force, start)
    with pytest.raises(ValueError, match="contiguous"):
        arnn_kernel.arnn_sampled_decode(params, ctx.transpose(0, 1).contiguous().transpose(0, 1),
                                        score, force, start)
    odd = _arnn_case(rng, 4, 576, 64, 8, 30, 12, torch.float32, cuda)
    with pytest.raises(ValueError, match="hidden size"):  # past the 512 ceiling
        arnn_kernel.arnn_sampled_decode(*odd)
    half = _arnn_case(rng, 4, 64, 64, 8, 30, 12, torch.float16, cuda)
    with pytest.raises(ValueError, match="dtype"):
        arnn_kernel.arnn_sampled_decode(*half)


# K8 vs its plain version on the card, by ``gru_kernel.agreement`` within
# ``gru_kernel.BOUNDS`` (the readings are in PERF.md).


def _gru_layer_case(rng, batch, steps, hidden, dtype, device, mask_kind):
    """xw, W_hh, b_hh, h0 and a mask: suffix lengths 0..steps (0: an
    all-zero row, the engine's "no future context"), target lengths
    1..steps with an all-zero row 0, interior zeros, or none."""
    arrays = [rng.standard_normal((batch, steps, 3 * hidden)) * 0.5,
              rng.standard_normal((hidden, 3 * hidden)) * (2.0 / (4 * hidden)) ** 0.5,
              rng.standard_normal(3 * hidden) * 0.1, rng.standard_normal((batch, hidden)) * 0.5]
    args = [torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype) for a in arrays]
    mask = None
    if mask_kind == "suffix":
        lengths = rng.integers(0, steps + 1, batch)
        lengths[0] = 0
        mask = (np.arange(steps)[None] < lengths[:, None]).astype(np.float32)
    elif mask_kind == "target":  # lengths 1..steps, and an all-zero row 0
        lengths = rng.integers(1, steps + 1, batch)
        lengths[0] = 0
        mask = (np.arange(steps)[None] < lengths[:, None]).astype(np.float32)
    elif mask_kind == "interior":
        mask = (rng.random((batch, steps)) < 0.7).astype(np.float32)
    return (*args, None if mask is None else torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,steps,hidden,mask,reverse,want_ys", [
    (37, 16, 512, "suffix", False, False), (37, 16, 512, "interior", True, True),
    (5, 6, 1024, "suffix", True, True), (1, 1, 1024, None, False, True),
    (33, 1, 1024, None, True, False), (70, 9, 64, "suffix", False, True)])
def test_gru_layer_kernel_matches_plain(cuda, dtype, batch, steps, hidden, mask, reverse,
                                        want_ys):
    args = _gru_layer_case(np.random.default_rng(batch + steps), batch, steps, hidden, dtype,
                           cuda, mask)
    before = lk.gru_layer_stream.launches
    got = lk.gru_layer_stream(*args, reverse=reverse, want_ys=want_ys)
    want = lk.gru_layer_reference(*args, reverse=reverse, want_ys=want_ys)
    torch.cuda.synchronize()
    assert lk.gru_layer_stream.launches == before + 1
    assert (got[0] is None) == (not want_ys) and got[1].shape == (batch, hidden)
    assert got[1].dtype == dtype and (got[0] is None or got[0].shape == (batch, steps, hidden))
    agree = lk.agreement(got, want)
    assert lk.within(agree, lk.BOUNDS[dtype]), agree
    if mask == "suffix":  # an all-zero row returns h0 and emits it at every step
        assert torch.equal(got[1][0], args[3][0])
        if want_ys:
            assert torch.equal(got[0][0], args[3][0][None].expand(steps, -1))


ROW_TILE_SHAPES = [(70, 4, 512, None), (37, 16, 512, "suffix"), (49, 6, 1024, "interior"),
                   (1, 1, 1024, None)]


@pytest.mark.parametrize("cluster,batch,steps,hidden,mask", [
    (c, *shape) for shape in ROW_TILE_SHAPES for c in cluster_sizes(shape[2])])
def test_gru_layer_kernel_bf16_row_tiles_match_plain(cuda, monkeypatch, cluster, batch, steps,
                                                      hidden, mask):
    """Every cluster size the plans can pick, whatever ``launch_plan``
    picks, at rows that fill no whole 64-row tile."""
    _with_cluster(monkeypatch, lk, cluster)
    args = _gru_layer_case(np.random.default_rng(batch * cluster), batch, steps, hidden,
                           torch.bfloat16, cuda, mask)
    got = lk.gru_layer_stream(*args, reverse=True)
    agree = lk.agreement(got, lk.gru_layer_reference(*args, reverse=True))
    assert lk.within(agree, lk.BOUNDS[torch.bfloat16]), agree


@pytest.mark.parametrize("batch,steps,hidden,mask,reverse,want_ys", [
    (1, 3, 1024, None, False, True), (37, 16, 512, "suffix", True, True),
    (130, 6, 1024, "target", False, False), (2100, 4, 128, "suffix", True, True),
    (37, 9, 64, "target", False, True), (130, 64, 512, "suffix", False, True)])
def test_gru_layer_kernel_bf16_every_cluster_size(cuda, monkeypatch, batch, steps, hidden, mask,
                                                  reverse, want_ys):
    """K8's Hopper route at each cluster size its width allows, at ragged
    rows: bit-equal across cluster sizes (a cluster only moves h between its
    CTAs: a missing fence in that exchange shows as a difference, most
    likely over the 64-step case), an all-zero mask row returns h0 and emits
    it, and the plain version's bounds hold. At 64 steps order flips cascade
    over more of the outputs than the 2% share calibrated for the engines'
    16 (2.6% seen on an H100), so there only the max bound applies."""
    args = _gru_layer_case(np.random.default_rng(batch + steps), batch, steps, hidden,
                           torch.bfloat16, cuda, mask)
    outs = {}
    for cluster in cluster_sizes(hidden):
        with monkeypatch.context() as m:
            _with_cluster(m, lk, cluster)
            outs[cluster] = lk.gru_layer_stream(*args, reverse=reverse, want_ys=want_ys)
    want = lk.gru_layer_reference(*args, reverse=reverse, want_ys=want_ys)
    torch.cuda.synchronize()
    got = outs[cluster_sizes(hidden)[0]]
    assert all(_bit_equal(o, got) for o in outs.values())
    bound = dict(lk.BOUNDS[torch.bfloat16])
    if steps > 16:
        bound.pop("share_changed")
    agree = lk.agreement(got, want)
    assert lk.within(agree, bound), agree
    if mask is not None:
        assert torch.equal(got[1][0], args[3][0])
        if want_ys:
            assert torch.equal(got[0][0], args[3][0][None].expand(steps, -1))


def test_gru_layer_kernel_bounds_reject_planted_faults(cuda, monkeypatch):
    """In bf16: a carry kept in f32, and a mask read one step late, planted
    in the plain version, break the bounds."""
    args = _gru_layer_case(np.random.default_rng(1), 64, 6, 1024, torch.bfloat16, cuda, "suffix")
    got = lk.gru_layer_stream(*args)
    monkeypatch.setattr(lk, "carry", lambda h, dtype: h)
    carry = lk.gru_layer_reference(*args)
    monkeypatch.undo()
    mask = args[4]
    late = lk.gru_layer_reference(*args[:4], torch.cat([mask[:, :1], mask[:, :-1]], dim=1))
    for planted in (carry, late):
        agree = lk.agreement(got, planted)
        assert not lk.within(agree, lk.BOUNDS[torch.bfloat16]), agree


@pytest.mark.parametrize("batch,steps,hidden,mask,reverse,want_ys", [
    (1, 3, 1024, None, False, True), (37, 16, 512, "suffix", True, True),
    (130, 6, 1024, "target", False, False), (2100, 4, 128, "suffix", True, True),
    (37, 9, 64, "interior", False, True), (130, 16, 512, "interior", True, False)])
def test_gru_layer_kernel_f32_reruns_bit_equal(cuda, batch, steps, hidden, mask, reverse,
                                               want_ys):
    """K8's f32 route (K5's split recurrence in mode kLayer: H / 64 CTAs a
    tile, 16 at H 1024) at ragged rows: within ``BOUNDS[float32]``, an
    all-zero mask row returns h0 and emits it, and a rerun is bit-equal. Its
    CTAs own 64 units whatever the rows, so a width has one cluster size:
    the race check is the rerun, over the widths' sizes 1, 2, 8 and 16."""
    args = _gru_layer_case(np.random.default_rng(batch + steps), batch, steps, hidden,
                           torch.float32, cuda, mask)
    got = lk.gru_layer_stream(*args, reverse=reverse, want_ys=want_ys)
    again = lk.gru_layer_stream(*args, reverse=reverse, want_ys=want_ys)
    want = lk.gru_layer_reference(*args, reverse=reverse, want_ys=want_ys)
    torch.cuda.synchronize()
    assert _bit_equal(got, again)
    agree = lk.agreement(got, want)
    assert lk.within(agree, lk.BOUNDS[torch.float32]), agree
    if mask in ("suffix", "target"):
        assert torch.equal(got[1][0], args[3][0])
        if want_ys:
            assert torch.equal(got[0][0], args[3][0][None].expand(steps, -1))


def test_gru_layer_kernel_f32_bounds_reject_planted_faults(cuda, monkeypatch):
    """K8 f32's traps, planted in the plain version, break ``BOUNDS[float32]``:
    the product on h taken as one bf16 piece, a mask read one step late,
    and a held row that writes no pieces for the next step (a reverse layer
    over suffix masks runs its rows after their holds)."""
    args = _gru_layer_case(np.random.default_rng(2), 70, 16, 512, torch.float32, cuda, "suffix")
    got = lk.gru_layer_stream(*args, reverse=True)
    assert lk.within(lk.agreement(got, lk.gru_layer_reference(*args, reverse=True)),
                     lk.BOUNDS[torch.float32])
    monkeypatch.setattr(lk, "layer_product", lambda h, w: split_bf16_pieces(h)[0].float() @ w)
    one_piece = lk.gru_layer_reference(*args, reverse=True)
    monkeypatch.undo()
    mask = args[4]
    late = lk.gru_layer_reference(*args[:4], torch.cat([mask[:, :1], mask[:, :-1]], dim=1),
                                  reverse=True)
    stale = lk.held_pieces_fault_reference(*args, reverse=True)
    for name, planted in (("one piece", one_piece), ("late mask", late), ("stale", stale)):
        agree = lk.agreement(got, planted)
        assert not lk.within(agree, lk.BOUNDS[torch.float32]), (name, agree)


def test_gru_layer_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(0)
    args = _gru_layer_case(rng, 4, 3, 64, torch.float32, cuda, "suffix")
    with pytest.raises(ValueError, match="dtype"):
        lk.gru_layer_stream(*(a.half() for a in args[:4]), args[4])
    with pytest.raises(ValueError, match="contiguous"):
        lk.gru_layer_stream(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="mask"):
        lk.gru_layer_stream(*args[:4], args[4][:, :2])
    for dtype in (torch.float32, torch.bfloat16):  # past 1024: tile groups, no ceiling
        odd = _gru_layer_case(rng, 4, 3, 1088, dtype, cuda, None)
        assert lk.within(lk.agreement(lk.gru_layer_stream(*odd), lk.gru_layer_reference(*odd)),
                         lk.BOUNDS[dtype])
    # a vocabulary past one 96-column head chunk, which K2 refused before its
    # head was chunked: within the plain version's bounds, K4 bit-equal
    for dtype in (torch.bfloat16, torch.float32):
        for vocab in (97, 256):
            params, tick_ctx, h_inits = _decode_case(rng, 37, 64, vocab, dtype, cuda)
            got = decode_kernel.decode_sampling(params, tick_ctx, h_inits)
            want = decode_kernel.decode_sampling_reference(params, tick_ctx, h_inits)
            got8 = decode_kernel.decode_sampling_int8(params, tick_ctx, h_inits)
            want8 = decode_kernel.decode_sampling_int8_reference(params, tick_ctx, h_inits)
            torch.cuda.synchronize()
            assert got[0].shape == (37, 24, vocab)
            assert (got[1] == want[1]).float().mean().item() >= 0.99
            same_rows = (got[1] == want[1]).all(dim=1)
            torch.testing.assert_close(got[0][same_rows].float(), want[0][same_rows].float(),
                                       rtol=0, atol=ATOL[dtype] * 4)
            assert _bit_equal(got8, want8)


# --------------------------------------------------------------------------- #
# Gradients through the kernel routes (kernel_common.kernel_with_eager_grad):
# the backward re-runs the eager route, so with a loss linear in the
# kernel's outputs the gradients equal that route's bit for bit. Embedding
# tables are left out: their gradients scatter-add with atomics, in no fixed
# order.
# --------------------------------------------------------------------------- #
def _dense_grads(tree, path=""):
    """{path: grad} of every leaf whose path names no embedding."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _dense_grads(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _dense_grads(sub, f"{path}/{i}").items()}
    return {} if "embedding" in path else {path: tree.grad}


def _leaf_copy(tree):
    if isinstance(tree, dict):
        return {k: _leaf_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_copy(v) for v in tree]
    return tree.detach().clone().requires_grad_(tree.is_floating_point())


def _same_grads(got: dict, eager: dict, must_move: str):
    assert got.keys() == eager.keys()
    for k in got:
        assert (got[k] is None) == (eager[k] is None), k
        if got[k] is not None:
            assert torch.equal(got[k], eager[k]), k
    moved = [k for k in got if must_move in k and got[k] is not None and got[k].abs().max() > 0]
    assert moved, f"no gradient reaches {must_move}"


def test_gradient_through_k2_reaches_the_generation_gru(cuda, monkeypatch):
    """LatentRNN's argmax decode through K2 (f32) under a gradient: the
    generation GRU's weights get the eager decode's gradients, bit for bit."""
    from inpaintnet_tpu_torch.models.presets import build_flagship

    _, vae, model = build_flagship(vocab_size=30, hidden=64, z_dim=12, emb=8, seed=3,
                                   device=cuda)
    assert vae.decoder.use_kernel()
    rng = np.random.default_rng(4)
    past, future = (torch.from_numpy(rng.integers(0, 30, (5, 3, 24)).astype(np.int32)).to(cuda)
                    for _ in range(2))
    target_mask = torch.ones((5, 2), device=cuda)
    eps = torch.from_numpy(rng.standard_normal((5 * 6, 12)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((5, 2, 24, 30)).astype(np.float32)).to(cuda)

    def grads():
        params, vae_params = _leaf_copy(model.params()), _leaf_copy(vae.params())
        weights, _, _ = model.apply(params, vae_params, past, future, target_mask=target_mask,
                                    eps=eps)
        (weights * w).sum().backward()
        return _dense_grads(params)

    before = decode_kernel.decode_sampling.launches
    got = grads()
    assert decode_kernel.decode_sampling.launches == before + 1
    monkeypatch.setattr(vae.decoder, "use_kernel", lambda dtype=None: False)
    _same_grads(got, grads(), "generation_rnn")


def test_gradient_through_k1_matches_the_eager_scan(cuda, monkeypatch):
    """The frozen encoder through K1 (f32) under a gradient: every GRU
    weight gets the eager scan's gradient, bit for bit. The loss is linear
    in h_n (the heads are taken out): behind a nonlinear head the cotangent
    reaching h_n would depend on the forward's own h_n, which the kernel
    and the eager scan round apart."""
    from inpaintnet_tpu_torch.models.presets import build_flagship

    _, vae, _ = build_flagship(vocab_size=30, hidden=64, z_dim=12, emb=8, seed=5, device=cuda)
    assert vae.encoder.use_kernel()
    monkeypatch.setattr(vae.encoder, "_heads", lambda params, h_n, batch: h_n)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, 30, (7, 24)).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((4, 7, 64)).astype(np.float32)).to(cuda)

    def grads():
        params = _leaf_copy(vae.params()["encoder"])
        (vae.encoder.apply(params, tokens) * w).sum().backward()
        return _dense_grads(params)

    before = encoder_kernel.encoder_hn.launches
    got = grads()
    assert encoder_kernel.encoder_hn.launches == before + 1
    monkeypatch.setattr(vae.encoder, "use_kernel", lambda dtype=None: False)
    _same_grads(got, grads(), "gru")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_through_k1_training_mode(cuda, monkeypatch, dtype):
    """The encoder's training forward through K1's training mode
    (``INPAINTNET_TRAIN_ENCODER_IMPL=pallas``, dropout 0.5, H 64): K1
    launches, K5/K6 do not, and under a loss linear in h_n every GRU weight
    gets the eager route's gradient (the eager scan under the same mask),
    bit for bit; the embedding table gets one too (its backward adds with
    atomics, so in no fixed order: held within a tolerance)."""
    from inpaintnet_tpu_torch.models.measure_vae import _encoder_eager_hn
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.models.base import cast_params

    _, vae, _ = build_flagship(vocab_size=30, hidden=64, z_dim=12, emb=8, seed=5, device=cuda)
    enc = vae.encoder
    monkeypatch.setenv("INPAINTNET_TRAIN_ENCODER_IMPL", "pallas")
    assert enc.use_train_kernel() and enc.dropout == 0.5
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, 30, (70, 24)).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((4, 70, 64)).astype(np.float32)).to(cuda)
    keep = torch.from_numpy(rng.random((70, 24, 128)) >= 0.5).to(cuda)
    monkeypatch.setattr(enc, "_heads", lambda params, h_n, batch: h_n)
    master = cast_params(vae.params()["encoder"], cuda, dtype)

    def grads(route):
        params = _leaf_copy(master)
        out = (route(params) * w).float().sum()
        out.backward()
        return _dense_grads(params), params["embedding"]["table"].grad

    counts = (encoder_kernel.encoder_hn, gk.gru_fwd_seq, gk.gru_bwd_seq)
    before = [k.launches for k in counts]
    got, got_emb = grads(lambda p: enc.apply(p, tokens, train=True, dropout_masks=[keep]))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counts, before)] == [1, 0, 0]
    eager, eager_emb = grads(lambda p: _encoder_eager_hn(
        p["gru"], p["embedding"]["table"], tokens, keep, 0.5))
    _same_grads(got, eager, "gru")
    assert got_emb is not None and got_emb.abs().max() > 0
    tol = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}[dtype]
    torch.testing.assert_close(got_emb.float(), eager_emb.float(), rtol=tol, atol=tol)


def test_gradient_through_k7_matches_the_eager_decode(cuda, monkeypatch):
    """The ARNN's inpainting decode through K7 (f32, H 64) under a
    gradient: the generation LSTM's and the head's weights get the eager
    argmax loop's gradients, bit for bit."""
    from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
    from inpaintnet_tpu_torch.models.presets import ARNNDataset

    model = AnticipationRNNBaseline(
        ARNNDataset(30), note_embedding_dim=8, metadata_embedding_dim=4,
        num_lstm_constraints_units=64, num_lstm_generation_units=64, linear_hidden_size=12,
        num_layers=2, unary_constraint=True, device=cuda, seed=7)
    assert model._use_kernel_decode(model.params())
    ticks, rng = 48, np.random.default_rng(8)
    score = torch.from_numpy(rng.integers(0, 30, (3, ticks)).astype(np.int32)).to(cuda)
    md = np.stack([m.generate(ticks) for m in model.dataset.metadatas]
                  + [np.zeros(ticks, np.int64)], axis=1).astype(np.int32)
    md = torch.from_numpy(md).to(cuda)[None].expand(3, -1, -1)
    loc = torch.ones((3, ticks), dtype=torch.int32, device=cuda)
    loc[:, 16:32] = 0
    w = torch.from_numpy(rng.standard_normal((3, ticks, 30)).astype(np.float32)).to(cuda)

    def grads():
        params = _leaf_copy(model.params())
        (model.apply_inpaint(params, score, md, loc)[0] * w).sum().backward()
        return _dense_grads(params)

    before = arnn_kernel.arnn_sampled_decode.launches
    got = grads()
    assert arnn_kernel.arnn_sampled_decode.launches == before + 1
    monkeypatch.setattr(model, "_use_kernel_decode", lambda p: False)
    _same_grads(got, grads(), "lstm_generation")


# --------------------------------------------------------------------------- #
# LatentRNN training: the frozen encoder on K5, the decode on K2
# --------------------------------------------------------------------------- #
def _latent_trainers(devices, auto_reg, hidden=64, rnn_hidden=64, seed=5):
    """A LatentRNN (every dropout 0 but the frozen decoder's, which the
    argmax decode never applies) over a frozen VAE of ``hidden`` units, one
    trainer a device, on the same 3 windows of 9 bars."""
    from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
    from inpaintnet_tpu_torch.train import LatentRNNTrainer
    from inpaintnet_tpu_torch.train.data import ArrayDataset

    vae = MeasureVAE(VocabOnlyDataset(30), note_embedding_dim=8, encoder_hidden_size=hidden,
                     latent_space_dim=12, decoder_hidden_size=hidden, device="cpu", seed=seed,
                     encoder_dropout_prob=0.0)
    model = LatentRNN(vae, 2, rnn_hidden, auto_reg, device="cpu", dropout=0.0, seed=seed + 1)
    windows = np.random.default_rng(seed).integers(0, 30, (3, 1, 9 * 24)).astype(np.int32)
    data = ArrayDataset((windows,), 9)
    return windows, model, [LatentRNNTrainer(data, model, lr=1e-3, device=d, seed=1)
                            for d in devices]


@pytest.mark.parametrize("auto_reg,coin", [(False, None), (True, True), (True, False)],
                         ids=["non_autoregressive", "teacher_forced", "sampled"])
def test_latent_rnn_train_step_on_card_matches_cpu(cuda, auto_reg, coin):
    """One LatentRNN train step, f32, H 64, the same split and injected
    noise: on the card (K5 for the frozen encoder, K2 for the decode with
    the eager scan's backward) against the CPU's plain versions. Loss and
    gradients within chip_smoke.py's TRAIN_REF bounds (f32 sums in another
    order); the K2 forward's tokens equal."""
    from inpaintnet_tpu_torch.models.base import iter_leaves

    windows, model, (card_tr, cpu_tr) = _latent_trainers((cuda, "cpu"), auto_reg)
    rng = np.random.default_rng(9)
    mt = model.max_target
    measures = 2 * 9 + (mt if model.use_teacher_forcing else 0)
    eps = torch.from_numpy(rng.standard_normal((3 * measures, 12)).astype(np.float32))
    eps_steps = torch.from_numpy(rng.standard_normal((mt - 1, 3, 12)).astype(np.float32))
    out = []
    for tr in (card_tr, cpu_tr):
        batch = tr.process_batch_data((windows,))
        before = (decode_kernel.decode_sampling.launches, gk.gru_fwd_seq.launches)
        weights, samples, _ = tr.model.apply(
            tr.params, tr.extra, batch[0], batch[2], batch[4], past_mask=batch[1],
            future_mask=batch[3], target_mask=batch[5], train=True, coin=coin,
            eps=eps.to(tr.device), eps_steps=eps_steps.to(tr.device))
        loss, _ = tr.loss_and_metrics(tr.params, batch, True, extra=tr.extra,
                                      eps=eps.to(tr.device), eps_steps=eps_steps.to(tr.device),
                                      coin=coin)
        loss.backward()
        launched = (decode_kernel.decode_sampling.launches - before[0],
                    gk.gru_fwd_seq.launches - before[1])
        out.append((loss.item(), samples.cpu(), launched,
                    [p.grad.cpu() for _, p in iter_leaves(tr.params) if p.grad is not None]))
    (l_c, s_c, n_c, g_c), (l_p, s_p, n_p, g_p) = out
    # per forward: K2 a decode; K5 4 an encode and, on the sampled branch,
    # 4 a step of the generation GRU (hidden 128, a width K5 takes)
    sampled = auto_reg and not coin
    assert n_c == ((mt if sampled else 1) * 2, (8 * mt if sampled else 4) * 2)
    assert n_p == (0, 0)
    assert torch.equal(s_c, s_p)
    assert abs(l_c - l_p) <= 1e-5 * abs(l_p)
    assert len(g_c) == len(g_p)
    for a, b in zip(g_c, g_p):
        assert ((a - b).abs() / (1.0 + b.abs())).max().item() <= 1e-5


def test_latent_rnn_sampled_step_at_generation_hidden_1024(cuda):
    """The autoregressive sampled branch at LatentRNN hidden 512 (generation
    GRU 1024, the widest K5/K6 take) over a small frozen VAE (H 64): the
    step runs, the generation GRU takes K5 and K6 (2 layers x 2 directions
    a target measure each) and never the eager loop, the frozen encoder K5
    (a context encode and 5 re-encodes) and never K6, and the generation
    GRU's weights get gradients."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.ops import gru as gru_mod

    windows, model, (tr,) = _latent_trainers((cuda,), True, rnn_hidden=512)
    assert model.gen_hidden_size == 1024 and gk.trainfast_supports(1024)
    mt = model.max_target
    wide, real = [0], gru_mod.gru_gates

    def counted(params, h, xw):
        wide[0] += h.shape[-1] == 1024
        return real(params, h, xw)

    before = (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches)
    gru_mod.gru_gates = counted
    try:
        loss, _ = tr.train_step(tr.process_batch_data((windows,)), coin=False)
    finally:
        gru_mod.gru_gates = real
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert wide[0] == 0
    assert gk.gru_fwd_seq.launches - before[0] == 8 * mt
    assert gk.gru_bwd_seq.launches - before[1] == 4 * mt
    grads = [p.grad for k, p in iter_leaves(tr.params) if k.startswith("generation_rnn")]
    assert all(g is not None for g in grads) and max(g.abs().max().item() for g in grads) > 0


# --------------------------------------------------------------------------- #
# AnticipationRNN training: the eager LSTMs under autograd, K7 in validation
# --------------------------------------------------------------------------- #
def _arnn_trainers(devices, kind, hidden=64, seed=5):
    """An ARNN (dropout 0.2 between the layers and on the input, unary
    constraints, teacher forcing) of ``hidden`` units, one trainer a device
    with the same seeded CPU generator of dropout masks, on the same 3
    windows of 9 bars."""
    from inpaintnet_tpu_torch.models.anticipation_rnn import (
        AnticipationRNNBaseline,
        ConstraintModelGaussianReg,
    )
    from inpaintnet_tpu_torch.models.presets import ARNNDataset
    from inpaintnet_tpu_torch.train import (
        AnticipationRNNBaselineTrainer,
        AnticipationRNNGaussianRegTrainer,
    )

    ds = ARNNDataset(30)
    ds.n_bars = 9
    model_cls, trainer_cls = ((ConstraintModelGaussianReg, AnticipationRNNGaussianRegTrainer)
                              if kind == "reg" else
                              (AnticipationRNNBaseline, AnticipationRNNBaselineTrainer))
    model = model_cls(ds, note_embedding_dim=10, metadata_embedding_dim=2,
                      num_lstm_constraints_units=hidden, num_lstm_generation_units=hidden,
                      linear_hidden_size=hidden, num_layers=2, dropout_input_prob=0.2,
                      dropout_prob=0.2, unary_constraint=True, device="cpu", seed=seed)
    ticks = 9 * 24
    rng = np.random.default_rng(seed)
    score = rng.integers(0, 30, (3, 1, ticks)).astype(np.int32)
    md = np.stack([m.generate(ticks) for m in ds.metadatas] + [np.zeros(ticks, np.int64)], 1)
    windows = (score, np.broadcast_to(md[None, None], (3, 1, ticks, 3)).astype(np.int32))
    trainers = []
    for d in devices:
        tr = trainer_cls(ds, model, lr=1e-3, device=d, seed=1)
        tr.generator = torch.Generator().manual_seed(11)
        trainers.append(tr)
    return windows, model, trainers


@pytest.mark.parametrize("kind", ["reg", "baseline"])
@pytest.mark.parametrize("coin", [True, False], ids=["teacher_forced", "sampled"])
def test_arnn_train_step_on_card_matches_cpu(cuda, kind, coin):
    """One ARNN train step, f32, H 64, the same constraint and dropout masks
    and coin: the eager LSTMs on the card against the CPU. Loss, gradients
    and the parameters after the Adam step within chip_smoke.py's TRAIN_REF
    bounds (f32 sums in another order); the sampled branch's tokens equal;
    K7 never launches in a train step."""
    from inpaintnet_tpu_torch.models.base import iter_leaves

    windows, model, (card_tr, cpu_tr) = _arnn_trainers((cuda, "cpu"), kind)
    tokens, scan = [], model._sampled_scan

    def recorded(*a, **k):
        out = scan(*a, **k)
        tokens.append(out[1].cpu())
        return out

    model._sampled_scan = recorded
    out = []
    for tr in (card_tr, cpu_tr):
        tokens.clear()
        before = arnn_kernel.arnn_sampled_decode.launches
        loss, _ = tr.train_step(tr.process_batch_data(windows), coin=coin)
        leaves = [p for _, p in iter_leaves(tr.params)]
        out.append((loss.item(), [p.grad.cpu() for p in leaves],
                    [p.detach().cpu() for p in leaves], list(tokens),
                    arnn_kernel.arnn_sampled_decode.launches - before))
    (l_c, g_c, p_c, t_c, k_c), (l_p, g_p, p_p, t_p, _) = out
    assert k_c == 0
    assert len(t_c) == len(t_p) == (0 if coin else 1)
    for a, b in zip(t_c, t_p):
        assert torch.equal(a, b)
    assert abs(l_c - l_p) <= 1e-5 * abs(l_p)
    for a, b in zip(g_c, g_p):
        assert ((a - b).abs() / (1.0 + b.abs())).max().item() <= 1e-5
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p_c, p_p)])
    assert diff.max().item() <= 2e-3 and diff.mean().item() <= 1e-6


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_arnn_validation_launches_k7_and_train_step_does_not(cuda, monkeypatch, dtype):
    """At a width K7 takes (64): a train step launches K7 on neither coin, a
    validation step once, and that call's logits and tokens hold against
    K7's plain version on the same inputs within ``K7_BOUNDS``."""
    from inpaintnet_tpu_torch.models import anticipation_rnn

    windows, model, (tr,) = _arnn_trainers((cuda,), "baseline")
    tr.compute_dtype = dtype
    batch = tr.process_batch_data(windows)
    for coin in (True, False):
        before = arnn_kernel.arnn_sampled_decode.launches
        loss, _ = tr.train_step(batch, coin=coin)
        assert np.isfinite(loss.item())
        assert arnn_kernel.arnn_sampled_decode.launches == before
    calls = []

    def recorded(*args):
        out = arnn_kernel.arnn_sampled_decode(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(anticipation_rnn, "arnn_sampled_decode", recorded)
    before = arnn_kernel.arnn_sampled_decode.launches
    val, _ = tr.eval_step(batch)
    assert arnn_kernel.arnn_sampled_decode.launches == before + 1 and len(calls) == 1
    assert np.isfinite(val.item())
    args, got = calls[0]
    assert args[1].is_cuda and args[2].shape == (3, 9 * 24)
    agree = arnn_kernel.decode_agreement(
        got, arnn_kernel.arnn_sampled_decode_reference(*args), args[3])
    assert arnn_kernel.within(agree, K7_BOUNDS[torch.bfloat16 if dtype else torch.float32]), \
        agree
