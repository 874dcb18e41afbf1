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

from inpaintnet_tpu_torch.ops import decode_kernel, encoder_kernel
from inpaintnet_tpu_torch.ops.gru import gru_init
from inpaintnet_tpu_torch.ops.linear import embedding_init, linear_init
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


def _tree(tree, device, dtype, rng):
    if isinstance(tree, dict):
        return {k: _tree(v, device, dtype, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, device, dtype, rng) for v in tree]
    noisy = tree + 0.1 * rng.standard_normal(tree.shape).astype(np.float32)
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


# int8 kernel vs plain version: bit-equal. Both take exact int32 products,
# and the kernel rounds every f32 multiply and add, and every exp and tanh,
# as the plain version's PyTorch CUDA ops do (gru_common.cuh gru_gate), so
# nothing is left to differ.


def _encoder_int8_case(rng, batch, hidden, dtype, device):
    gru = _tree(gru_init(rng, 10, hidden, 2, True), device, dtype, rng)
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
    with pytest.raises(ValueError, match="hidden size"):
        odd = _tree(gru_init(rng, 10, 48, 2, True), cuda, torch.bfloat16, rng)
        encoder_kernel.encoder_hn(odd, table, tokens.int())
    with pytest.raises(ValueError, match="dtype"):
        encoder_kernel.encoder_hn_int8(gru, table, tokens)
    with pytest.raises(ValueError, match="hidden size"):
        encoder_kernel.encoder_hn_int8(odd, table, tokens.int())
