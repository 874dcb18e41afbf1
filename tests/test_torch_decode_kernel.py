"""K2's plain version (``decode_sampling_reference``) against the JAX
package's Pallas kernel (interpret mode) and its XLA scan, from the same
parameters and per-beat inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models.measure_vae import NUM_BEATS_PER_MEASURE, HierarchicalDecoder
from inpaintnet_tpu.ops.decode_pallas import decode_sampling_pallas
from inpaintnet_tpu.ops.linear import linear_apply
from inpaintnet_tpu_torch.ops import decode_kernel

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-5  # f32 on both sides; only summation order differs


def _setup(batch, vocab=30, hidden=32, z_dim=16, seed=0):
    dec = HierarchicalDecoder(note_embedding_dim=10, num_notes=vocab, z_dim=z_dim,
                              num_layers=2, rnn_hidden_size=hidden, dropout=0.5)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(x.shape), jnp.float32),
        dec.init_params(jax.random.PRNGKey(seed)))
    z = jnp.asarray(rng.standard_normal((batch, z_dim)), jnp.float32)
    beat_out = dec._beat_outputs(params, z, train=False, rng=jax.random.PRNGKey(9))
    tick_ctx = jax.nn.selu(linear_apply(params["beat_to_tick_input"], beat_out))
    h_inits = dec._tick_h0(
        params, beat_out.reshape(batch * NUM_BEATS_PER_MEASURE, -1)
    ).reshape(2, batch, NUM_BEATS_PER_MEASURE, -1)
    return dec, params, tick_ctx, h_inits


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _reference(params, tick_ctx, h_inits):
    return decode_kernel.decode_sampling_reference(_torch(params), _torch(tick_ctx),
                                                   _torch(h_inits))


@pytest.mark.parametrize("batch", [12, 13])  # 13: not a multiple of the TPU tile
def test_reference_matches_pallas_and_scan(batch):
    dec, params, tick_ctx, h_inits = _setup(batch)
    lg, s = _reference(params, tick_ctx, h_inits)
    pw, ps = decode_sampling_pallas(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    sw, ss = dec._decode_scan(params, tick_ctx, h_inits, train=False,
                              rng=jax.random.PRNGKey(0), score_tensor=None)
    assert lg.shape == (batch, 24, 30) and s.dtype == torch.int32
    for w_ref, s_ref in ((pw, ps), (sw, ss)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
        np.testing.assert_allclose(lg.numpy(), np.asarray(w_ref), atol=ATOL)


def test_all_zero_logits_sample_token_zero():
    """A head bias that forces every ReLU'd logit to 0 makes every tick a
    full tie: the first index (token 0) must win everywhere."""
    dec, params, tick_ctx, h_inits = _setup(6, seed=2)
    params = dict(params, head={"w": jnp.zeros_like(params["head"]["w"]),
                                "b": -jnp.ones_like(params["head"]["b"])})
    lg, s = _reference(params, tick_ctx, h_inits)
    _, ps = decode_sampling_pallas(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    assert float(lg.abs().max()) == 0.0
    assert s.eq(0).all() and np.all(np.asarray(ps) == 0)


def test_port_decode_scan_and_wrapper_match_reference():
    """The port's own XLA-scan twin (``_decode_scan``) and the CPU route of
    the wrapper agree with the plain version; the wrapper launches nothing."""
    from inpaintnet_tpu_torch.models.measure_vae import HierarchicalDecoder as TDecoder

    _, params, tick_ctx, h_inits = _setup(7, seed=3)
    tdec = TDecoder(10, 30, 16, 2, 32, device="meta")
    args = (_torch(params), _torch(tick_ctx), _torch(h_inits))
    lg, s = decode_kernel.decode_sampling_reference(*args)
    before = decode_kernel.decode_sampling.launches
    wl, ws = decode_kernel.decode_sampling(*args)
    sl, ss = tdec._decode_scan(*args)
    assert decode_kernel.decode_sampling.launches == before
    torch.testing.assert_close(ws, s, rtol=0, atol=0)
    torch.testing.assert_close(wl, lg, rtol=0, atol=0)
    torch.testing.assert_close(ss, s, rtol=0, atol=0)
    torch.testing.assert_close(sl, lg, rtol=0, atol=ATOL)
