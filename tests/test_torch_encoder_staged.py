"""The staged encoder of K1's bf16 route and K3 (layer 0, then layer 1's
input projection for every step at once, then layer 1's recurrence on it)
in plain PyTorch, against the step-by-step plain versions and the JAX
package's Pallas kernels (interpret mode, as its own tests run them on the
CPU), from the same seeded numpy inputs; and the layouts the Hopper
kernels read, built on the host."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.ops import encoder_pallas
from inpaintnet_tpu_torch.ops import encoder_kernel as ek
from inpaintnet_tpu_torch.ops.gru import gru_init
from inpaintnet_tpu_torch.ops.linear import embedding_init

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

# staged vs step by step in f32: the same products, their f32 sums blocked
# differently (one (T*B, 2H) product against one (B, 2H) product a step)
STAGED_F32 = 1e-6
# against the Pallas kernels, the tolerances of test_torch_encoder_kernel.py
# (K1: f32 1e-5; bf16 two bf16 ulps of |h| < 1, for a carry rounding that
# the order of the sums flips) and test_torch_int8_kernels.py (K3)
PALLAS_ATOL = {"float32": 1e-5, "bfloat16": 8e-3}
PALLAS_ATOL_INT8 = {"float32": 1e-4, "bfloat16": 4 / 127}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(batch, hidden, vocab, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        gru_init(rng, 10, hidden, 2, True))
    table = embedding_init(rng, vocab, 10)["table"]
    tokens = rng.integers(0, vocab, (batch, 24)).astype(np.int32)
    return params, table, tokens


def _torch(tree, dtype):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.asarray(x)).to(dtype), tree)


def _jax(tree, dtype):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.dtype(dtype)), tree)


@pytest.mark.parametrize("batch,hidden", [(13, 64), (9, 128)])
def test_staged_equals_step_by_step_f32(batch, hidden):
    params, table, tokens = _inputs(batch, hidden, 30, seed=batch)
    args = (_torch(params, torch.float32), torch.from_numpy(table), torch.from_numpy(tokens))
    staged = ek.encoder_hn_staged_reference(*args)
    assert staged.shape == (4, batch, hidden) and staged.dtype == torch.float32
    torch.testing.assert_close(staged, ek.encoder_hn_reference(*args), rtol=0,
                               atol=STAGED_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,hidden", [(13, 64), (9, 128)])
def test_staged_int8_bit_equal_to_step_by_step(batch, hidden, dtype):
    params, table, tokens = _inputs(batch, hidden, 61, seed=batch + 1)
    args = (_torch(params, TORCH_DTYPES[dtype]), torch.from_numpy(table).to(TORCH_DTYPES[dtype]),
            torch.from_numpy(tokens))
    staged = ek.encoder_hn_int8_staged_reference(*args)
    assert staged.dtype == TORCH_DTYPES[dtype]
    assert torch.equal(staged, ek.encoder_hn_int8_reference(*args))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_matches_pallas(dtype):
    params, table, tokens = _inputs(11, 64, 30, seed=5)
    staged = ek.encoder_hn_staged_reference(
        _torch(params, TORCH_DTYPES[dtype]), torch.from_numpy(table).to(TORCH_DTYPES[dtype]),
        torch.from_numpy(tokens))
    h_pallas = encoder_pallas.encoder_hn_pallas(_jax(params, dtype), _jax(table, dtype),
                                                jnp.asarray(tokens), tile_b=8, interpret=True)
    np.testing.assert_allclose(staged.float().numpy(),
                               np.asarray(h_pallas.astype(jnp.float32)),
                               atol=PALLAS_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_int8_matches_pallas(dtype):
    params, table, tokens = _inputs(13, 64, 60, seed=13)
    staged = ek.encoder_hn_int8_staged_reference(
        _torch(params, TORCH_DTYPES[dtype]), torch.from_numpy(table).to(TORCH_DTYPES[dtype]),
        torch.from_numpy(tokens))
    h_pallas = encoder_pallas.encoder_hn_pallas_int8(_jax(params, dtype), _jax(table, dtype),
                                                     jnp.asarray(tokens), tile_b=8,
                                                     interpret=True)
    np.testing.assert_allclose(staged.float().numpy(),
                               np.asarray(h_pallas.astype(jnp.float32)),
                               atol=PALLAS_ATOL_INT8[dtype])


def test_projection_plain_versions_equal_per_step_products():
    """The GEMMs' plain versions hold every step's product: f32 sums
    within blocking, int8 sums exact."""
    rng = np.random.default_rng(3)
    ys = torch.from_numpy(rng.uniform(-1, 1, (4 * 5, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 128, 192)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 192)).astype(np.float32))
    out = ek.input_projection_reference(ys, w, b)
    assert out.shape == (2, 20, 192) and out.dtype == torch.float32
    for d in range(2):
        torch.testing.assert_close(out[d], ys @ w[d] + b[d], rtol=1e-6, atol=1e-6)
    ys_q = torch.from_numpy(rng.integers(-127, 128, (20, 128)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (2, 128, 192)).astype(np.int8))
    acc = ek.input_projection_int8_reference(ys_q, w_q)
    exact = torch.einsum("mk,dkn->dmn", ys_q.long(), w_q.long())
    assert torch.equal(acc.long(), exact)


@pytest.mark.parametrize("hidden,k_multiple", [(64, 64), (128, 128), (64, 128), (192, 128)])
def test_pack_gate_slabs_layout(hidden, k_multiple):
    """Row 96c + 32g + u of the packed W^T is gate g's column of unit
    32c + u; K is zero-padded to a multiple of ``k_multiple``."""
    w = torch.arange(hidden * 3 * hidden, dtype=torch.float32).reshape(hidden, 3 * hidden)
    packed = ek.pack_gate_slabs(w, k_multiple)
    hk = -(-hidden // k_multiple) * k_multiple
    assert packed.shape == (3 * hidden, hk) and packed.is_contiguous()
    for c in range(hidden // 32):
        for g in range(3):
            rows = packed[96 * c + 32 * g: 96 * c + 32 * g + 32, :hidden]
            torch.testing.assert_close(rows, w[:, g * hidden + 32 * c: g * hidden + 32 * c + 32].t())
    assert not packed[:, hidden:].any()


def test_chunk_rows_cap_the_projection_scratch():
    rows = ek.encoder_chunk_rows(65536, 24, 512)
    assert rows == 8192 and 2 * 24 * rows * 3 * 512 * 4 <= ek.XW_SCRATCH_BYTES
    assert ek.encoder_chunk_rows(1, 24, 512) == 1
    assert ek.encoder_chunk_rows(200, 24, 64, max_chunk_rows=64) == 64
    assert ek.encoder_cuda_launches(torch.bfloat16, 65536, 24, 512) == 24
    assert ek.encoder_cuda_launches(torch.bfloat16, 200, 24, 64, max_chunk_rows=64) == 12
    # f32: layer 0's outputs as three bf16 pieces and the h-piece exchange
    # beside the projection: half the rows a chunk, three launches each
    f32_rows = ek.encoder_chunk_rows(65536, 24, 512, dtype=torch.float32)
    assert f32_rows == 4096
    assert f32_rows * (2 * 24 * 3 * 512 * 4 + 24 * 2 * 512 * 6 + 2 * 2 * 3 * 512 * 2) <= \
        ek.XW_SCRATCH_BYTES
    assert ek.encoder_cuda_launches(torch.float32, 65536, 24, 512) == 48
    assert ek.encoder_cuda_launches(torch.float32, 200, 24, 64, max_chunk_rows=64) == 12


def test_wrappers_on_cpu_run_the_plain_versions_without_launching():
    params, table, tokens = _inputs(5, 64, 30, seed=2)
    args = (_torch(params, torch.float32), torch.from_numpy(table), torch.from_numpy(tokens))
    before = (ek.encoder_hn.launches, ek.encoder_hn_int8.launches)
    assert torch.equal(ek.encoder_hn(*args, max_chunk_rows=2), ek.encoder_hn_reference(*args))
    assert torch.equal(ek.encoder_hn_int8(*args, max_chunk_rows=2),
                       ek.encoder_hn_int8_reference(*args))
    assert (ek.encoder_hn.launches, ek.encoder_hn_int8.launches) == before
    ys = torch.ones((6, 128))
    w = torch.ones((2, 128, 192))
    assert torch.equal(ek.input_projection(ys, w, torch.zeros((2, 192))),
                       ek.input_projection_reference(ys, w, torch.zeros((2, 192))))
    assert torch.equal(ek.input_projection_int8(ys.to(torch.int8), w.to(torch.int8)),
                       ek.input_projection_int8_reference(ys.to(torch.int8), w.to(torch.int8)))
