"""The port's int8 quantization, per-row keys and per-row noise against the
JAX package's, on the CPU: the quantizers and ``derive_row_keys`` are
integer or single-rounding functions, so they must match bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.ops import quantize as jq
from inpaintnet_tpu.serve import derive_row_keys as jax_derive_row_keys
from inpaintnet_tpu_torch.ops import quantize as tq
from inpaintnet_tpu_torch.ops.distributions import row_bits, row_normal
from inpaintnet_tpu_torch.serve import _splitmix64, derive_row_keys


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes; one intra-op thread each
    keeps torch's thread pools from oversubscribing the cores, which slows
    the many tiny eager ops of these tests several-fold. Other test modules
    import this fixture, which makes it theirs too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((64, 96))).astype(np.float32)
    # column 0 holds exact .5 ties: its max is 127, so its scale is exactly 1
    w[:, 0] = np.arange(64) - 31.5
    w[0, 0] = 127.0
    w[:, 1] = 0.0  # an all-zero column: the scale floor of 1e-12
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_cols_int8_bit_equal(dtype, seed):
    w = _weights(seed)
    jqv, js = jq.quantize_cols_int8(jnp.asarray(w, dtype))
    tqv, ts = tq.quantize_cols_int8(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (1, 96)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # half-to-even at the ties: -31.5 -> -32, -30.5 -> -30, 0.5 -> 0, 1.5 -> 2
    col = tqv[:, 0].numpy()
    assert col[0] == 127 and col[1] == -30 and col[32] == 0 and col[33] == 2


def test_quantize_h_int8_and_dequantize_bit_equal():
    rng = np.random.default_rng(2)
    h = np.tanh(rng.standard_normal((40, 64))).astype(np.float32)
    # exact ties at a power-of-two scale: h * 2 = k + 0.5
    ties = np.array([0.25, 0.75, 1.25, -0.25, -0.75, 63.25], np.float32)
    q_rows = (127.0 / np.maximum(1.0, 3 * np.abs(rng.standard_normal((40, 1))))).astype(np.float32)
    for qscale_j, qscale_t, x in (
            (127.0, 127.0, h),
            (2.0, 2.0, ties),
            (jnp.asarray(q_rows), torch.from_numpy(q_rows), 4 * h)):
        jv = np.asarray(jq.quantize_h_int8(jnp.asarray(x), qscale_j))
        tv = tq.quantize_h_int8(torch.from_numpy(x), qscale_t)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(
            tq.dequantize_h(tv, qscale_t).numpy(),
            np.asarray(jq.dequantize_h(jnp.asarray(jv), qscale_j)))
    np.testing.assert_array_equal(tq.quantize_h_int8(torch.from_numpy(ties), 2.0).numpy(),
                                  [0, 2, 2, 0, -2, 126])
    assert tq.H_SCALE == jq.H_SCALE


@pytest.mark.parametrize("seed,n", [(0, 1), (5, 64), (2**63 + 11, 9), (-3, 4)])
def test_derive_row_keys_bit_equal(seed, n):
    keys = derive_row_keys(seed, n)
    assert keys.dtype == np.uint32 and keys.shape == (n, 2)
    np.testing.assert_array_equal(keys, jax_derive_row_keys(seed, n))


def test_row_noise_is_a_function_of_the_row_key_alone():
    """Row b's noise equals the noise of b's key drawn alone, wherever b sits
    in the batch; the hash equals numpy's uint64 splitmix64; the draws are
    standard normal."""
    keys = torch.from_numpy(derive_row_keys(7, 64).astype(np.int64))
    z = row_normal(keys, (32, 12))
    assert z.shape == (64, 32, 12) and z.dtype == torch.float32
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(row_normal(keys[perm], (32, 12)), z[perm], rtol=0, atol=0)
    torch.testing.assert_close(row_normal(keys[5:6], (32, 12))[0], z[5], rtol=0, atol=0)
    assert not torch.equal(z[0], z[1])

    with np.errstate(over="ignore"):
        k = keys.numpy().astype(np.uint64)
        key64 = (k[:, 0] << np.uint64(32)) | k[:, 1]
        ref = _splitmix64(_splitmix64(key64)[:, None] ^ np.arange(10, dtype=np.uint64)[None])
    np.testing.assert_array_equal(row_bits(keys, 10).numpy().view(np.uint64), ref)

    big = row_normal(torch.from_numpy(derive_row_keys(1, 256).astype(np.int64)), (32, 256))
    # 2M draws: the mean's standard error is 7e-4, the std's 5e-4
    assert abs(big.mean().item()) < 4e-3 and abs(big.std().item() - 1) < 4e-3
    assert bool(torch.isfinite(big).all()) and big.abs().max().item() < 6
