"""K1's plain version (``encoder_hn_reference``) against the JAX package's
Pallas kernel (interpret mode, as its own tests run it on the CPU) and
against its XLA scan, from the same seeded numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.ops.encoder_pallas import encoder_hn_pallas
from inpaintnet_tpu.ops.gru import gru_apply as jax_gru_apply
from inpaintnet_tpu_torch.ops import encoder_kernel
from inpaintnet_tpu_torch.ops.gru import gru_init
from inpaintnet_tpu_torch.ops.linear import embedding_init

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL_F32 = 1e-5  # f32 on both sides; only summation order differs
# bf16: both round the carry and the layer-0 outputs to bf16 every step;
# a summation-order difference can flip one rounding, a bf16 ulp (up to
# 2^-8 at |h| < 1) that the recurrence carries on: two such ulps (seen: 1e-3)
ATOL_BF16 = 8e-3


def _inputs(batch, hidden, vocab, seed):
    rng = np.random.default_rng(seed)
    E, T = 10, 24
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        gru_init(rng, E, hidden, 2, True))
    table = embedding_init(rng, vocab, E)["table"]
    tokens = rng.integers(0, vocab, (batch, T)).astype(np.int32)
    return params, table, tokens


def _torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.asarray(x)).to(dtype), tree)


@pytest.mark.parametrize("batch,hidden,vocab", [(13, 16, 30), (8, 32, 61), (20, 32, 60)])
def test_reference_matches_pallas_and_scan_f32(batch, hidden, vocab):
    params, table, tokens = _inputs(batch, hidden, vocab, seed=batch)
    h_ref = encoder_kernel.encoder_hn_reference(_torch(params), torch.from_numpy(table),
                                                torch.from_numpy(tokens))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    h_pallas = encoder_hn_pallas(jp, jnp.asarray(table), jnp.asarray(tokens), tile_b=8,
                                 interpret=True)
    _, h_scan = jax_gru_apply(jp, jnp.take(jnp.asarray(table), tokens, axis=0),
                              last_outputs=False)
    assert h_ref.shape == (4, batch, hidden)
    np.testing.assert_allclose(h_ref.numpy(), np.asarray(h_pallas), atol=ATOL_F32)
    np.testing.assert_allclose(h_ref.numpy(), np.asarray(h_scan), atol=ATOL_F32)


def test_reference_matches_pallas_bf16():
    params, table, tokens = _inputs(11, 32, 30, seed=5)
    h_ref = encoder_kernel.encoder_hn_reference(
        _torch(params, torch.bfloat16), torch.from_numpy(table).bfloat16(),
        torch.from_numpy(tokens))
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    h_pallas = encoder_hn_pallas(jp, jnp.asarray(table, jnp.bfloat16), jnp.asarray(tokens),
                                 tile_b=8, interpret=True)
    assert h_ref.dtype == torch.bfloat16
    np.testing.assert_allclose(h_ref.float().numpy(),
                               np.asarray(h_pallas.astype(jnp.float32)), atol=ATOL_BF16)


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    params, table, tokens = _inputs(5, 16, 30, seed=1)
    before = encoder_kernel.encoder_hn.launches
    args = (_torch(params), torch.from_numpy(table), torch.from_numpy(tokens))
    torch.testing.assert_close(encoder_kernel.encoder_hn(*args),
                               encoder_kernel.encoder_hn_reference(*args), rtol=0, atol=0)
    assert encoder_kernel.encoder_hn.launches == before
