"""Port ops (inpaintnet_tpu_torch.ops) against the JAX package's, on the
CPU in f32 at atol 1e-5: the same seeded numpy inputs go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu import ops as jops
from inpaintnet_tpu.ops.gru import gru_layer_apply as jax_gru_layer_apply
from inpaintnet_tpu_torch.ops import gru as tgru
from inpaintnet_tpu_torch.ops import linear as tlinear
from inpaintnet_tpu_torch.ops.distributions import DiagNormal
from inpaintnet_tpu_torch.ops.sampling import sample_argmax

from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-5  # f32 on both sides; only summation order differs


def _t(tree):
    """numpy (or jax) leaves -> torch tensors, keeping dicts and lists."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jitter(tree, rng, scale=0.1):
    """Add noise to every leaf (zero-initialised biases would hide bias bugs)."""
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree)


def test_linear_mlp_embedding_match_jax():
    rng = np.random.default_rng(0)
    lin = _jitter(tlinear.linear_init(rng, 7, 5), rng)
    mlp = _jitter(tlinear.mlp_selu_init(rng, 7, 6, 4), rng)
    emb = tlinear.embedding_init(rng, 11, 3)
    x = rng.standard_normal((4, 7)).astype(np.float32)
    idx = rng.integers(0, 11, (4, 5)).astype(np.int32)
    np.testing.assert_allclose(tlinear.linear_apply(_t(lin), _t(x)).numpy(),
                               np.asarray(jops.linear_apply(_j(lin), x)), atol=ATOL)
    np.testing.assert_allclose(tlinear.mlp_selu_apply(_t(mlp), _t(x)).numpy(),
                               np.asarray(jops.mlp_selu_apply(_j(mlp), x)), atol=ATOL)
    np.testing.assert_array_equal(tlinear.embedding_apply(_t(emb), _t(idx)).numpy(),
                                  np.asarray(jops.embedding_apply(_j(emb), idx)))


def test_xavier_normal_std():
    w = tlinear.xavier_normal(np.random.default_rng(0), (300, 500))
    assert w.dtype == np.float32
    assert abs(w.std() - np.sqrt(2.0 / 800)) < 2e-3


def _masks(kind, batch, seq_len, rng):
    if kind is None:
        return None
    lengths = rng.integers(1, seq_len + 1, batch)
    if kind == "zero_row":
        lengths[0] = 0  # all-zero mask: the engine's "no future context"
    return (np.arange(seq_len)[None] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("layers,bidir,mask,with_h0,last_outputs", [
    (1, False, None, False, True),
    (2, True, None, True, True),
    (2, True, "prefix", False, False),
    (2, True, "zero_row", True, False),
    (1, False, "zero_row", True, True),
])
def test_gru_apply_matches_jax(layers, bidir, mask, with_h0, last_outputs):
    rng = np.random.default_rng(layers * 10 + int(bidir))
    B, T, I, H = 5, 7, 6, 8
    dirs = 2 if bidir else 1
    params = _jitter(tgru.gru_init(rng, I, H, layers, bidir), rng)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    h0 = rng.standard_normal((layers * dirs, B, H)).astype(np.float32) if with_h0 else None
    m = _masks(mask, B, T, rng)
    out_t, hn_t = tgru.gru_apply(_t(params), _t(x), None if h0 is None else _t(h0),
                                 mask=None if m is None else _t(m), last_outputs=last_outputs)
    out_j, hn_j = jops.gru_apply(_j(params), x, h0, mask=m, last_outputs=last_outputs)
    np.testing.assert_allclose(hn_t.numpy(), np.asarray(hn_j), atol=ATOL)
    if last_outputs:
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    else:
        assert out_t is None and out_j is None
    if mask == "zero_row":  # a fully masked row keeps its h0 (zeros when none)
        expect = np.zeros((layers * dirs, H)) if h0 is None else h0[:, 0]
        np.testing.assert_allclose(hn_t.numpy()[:, 0], expect, atol=ATOL)


def test_gru_layer_reverse_matches_jax():
    rng = np.random.default_rng(3)
    params = _jitter(tgru.gru_cell_init(rng, 4, 6), rng)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    h0 = rng.standard_normal((3, 6)).astype(np.float32)
    m = _masks("prefix", 3, 5, rng)
    ys_t, h_t = tgru.gru_layer_apply(_t(params), _t(x), _t(h0), reverse=True, mask=_t(m))
    ys_j, h_j = jax_gru_layer_apply(_j(params), x, h0, reverse=True, mask=m)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)


def test_sample_argmax_first_index_on_ties():
    logits = torch.tensor([[0.0, 0.0, 0.0], [1.0, 3.0, 3.0], [2.0, 2.0, 1.0],
                           [0.5, 0.0, 0.5]])
    expect = [0, 1, 0, 0]
    assert sample_argmax(logits).tolist() == expect
    assert np.asarray(jops.sample_argmax(jnp.asarray(logits.numpy()))).tolist() == expect


def test_diag_normal_rsample():
    rng = np.random.default_rng(4)
    loc, scale, eps = (torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
                       for _ in range(3))
    dist = DiagNormal(loc, scale.abs())
    torch.testing.assert_close(dist.rsample(eps=eps), loc + scale.abs() * eps)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    torch.testing.assert_close(dist.rsample(generator=g1), dist.rsample(generator=g2))
