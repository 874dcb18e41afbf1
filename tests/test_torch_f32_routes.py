"""The kernel routes under a gradient, and the f32 routes of K2 and K8, on
the CPU.

- ``kernel_common.kernel_with_eager_grad`` under the port's three kernel
  routes (K1/K3's encoder, K2/K4's decode, K7's ARNN decode): on the CPU
  the kernel wrappers run their plain versions, which stand in for the
  kernels under ``no_grad``. The gradients must equal the eager route's
  bit for bit (the backward is that route, re-run) and the JAX package's
  ``kernel_with_xla_grad`` gradients (its kernels in interpret mode) within
  2e-5.
- The f32 routes of K2 (``decode_hopper.cuh decode_f32_kernel``) and K8
  (``gru_fwd_hopper.cuh`` mode ``kLayer``): their launch plans, their
  weight pieces as the kernels' TMA boxes read them, and their arithmetic
  as a plain emulation on ``kernel_common.split_product`` (every product
  on h as six bf16 passes a 64-wide k-slab), held against the plain
  versions and the JAX kernels in interpret mode within the f32 bounds; the
  same emulation on one bf16 piece of h, and the planted faults, break
  them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inpaintnet_tpu.models import measure_vae as jax_mv
from inpaintnet_tpu.models.anticipation_rnn import ConstraintModelGaussianReg as JaxCMGR
from inpaintnet_tpu.ops.decode_pallas import decode_sampling_pallas
from inpaintnet_tpu.ops.gru_pallas import gru_layer_pallas_stream
from inpaintnet_tpu_torch.ops import decode_kernel, encoder_kernel
from inpaintnet_tpu_torch.ops import gru_kernel as gk
from inpaintnet_tpu_torch.ops import kernel_common as kc
from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_sampled_decode
from inpaintnet_tpu_torch.ops.gru_train_kernel import pack_fwd_weights

from test_torch_arnn import make_batch, make_pair
from test_torch_decode_kernel import _setup as decode_setup
from test_torch_decode_kernel import _torch
from test_torch_gru_layer import _case, _jax, _to_torch
from test_torch_latent_rnn import VOCAB, Z, _jax_models, _port
from test_torch_quantize import _one_torch_thread  # noqa: F401  (autouse fixture)

GRAD_ATOL = 2e-5  # the port's gradients against JAX's: f32 sums in other orders


@pytest.fixture
def open_jax_gates(monkeypatch):
    """The JAX package's kernel routes on the CPU, as its own tests run them."""
    monkeypatch.setenv("INPAINTNET_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_mv.Encoder, "_use_pallas", lambda self, p: True)
    monkeypatch.setattr(jax_mv.HierarchicalDecoder, "_use_pallas_decode", lambda self, p: True)
    monkeypatch.setattr(JaxCMGR, "_use_pallas_decode", lambda self, p: True)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _grads_of(loss_fn, params, *extra):
    """loss_fn(params, *extra) backward -> the gradients of every float leaf
    of params and of ``extra``, in ``jax.tree_util`` leaf order."""
    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(params)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves)
    xs = [x.detach().clone().requires_grad_(True) for x in extra]
    loss_fn(tree, *xs).backward()
    return [t.grad for t in leaves + xs]


def _assert_grads(got, eager, want):
    """``got`` (the kernel route's) equals ``eager`` bit for bit and JAX's
    ``want`` within GRAD_ATOL; some leaf moves (the gradient is not all
    zeros or missing)."""
    assert len(got) == len(eager) == len(want)
    for g, e, w in zip(got, eager, want):
        g = torch.zeros_like(e) if g is None and e is None else g
        e = torch.zeros_like(g) if e is None else e
        g = torch.zeros_like(e) if g is None else g
        torch.testing.assert_close(g, e, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)
    assert any(g is not None and float(g.abs().max()) > 0 for g in got)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_decode_gradient_is_the_eager_scans(open_jax_gates, monkeypatch, quant):
    """K2's route (and K4's, whose twin is the same unquantized scan) under
    a gradient, from the logits back to z and every decoder weight."""
    jvae, jmodel = _jax_models(64, seed=2)
    vae, _ = _port(jvae, jmodel, 64)
    dec = vae.decoder
    assert dec.use_kernel()
    rng = np.random.default_rng(3)
    z = rng.standard_normal((5, Z)).astype(np.float32)
    w = rng.standard_normal((5, 24, VOCAB)).astype(np.float32)
    params = vae.params()["decoder"]
    wt = torch.from_numpy(w)

    def loss(p, zt):
        return (dec.decode_sampling(p, zt, quant)[0] * wt).sum()

    before = decode_kernel.decode_sampling.launches + decode_kernel.decode_sampling_int8.launches
    got = _grads_of(loss, params, torch.from_numpy(z))
    assert (decode_kernel.decode_sampling.launches
            + decode_kernel.decode_sampling_int8.launches) == before
    monkeypatch.setattr(dec, "use_kernel", lambda dtype=None: False)
    eager = _grads_of(loss, params, torch.from_numpy(z))

    jp = jax.tree_util.tree_map(jnp.asarray, jvae.params["decoder"])

    def jloss(p, zj):
        lg, _ = jvae.decoder.decode_sampling(p, zj, train=False, rng=jax.random.PRNGKey(0))
        return jnp.sum(lg * w)

    gp, gz = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(z))
    _assert_grads(got, eager, _leaves(gp) + [gz])


def test_encoder_gradient_is_the_eager_scans(open_jax_gates, monkeypatch):
    """K1's route under a gradient, from z's mean and scale back to every
    encoder weight."""
    jvae, jmodel = _jax_models(64, seed=4)
    vae, _ = _port(jvae, jmodel, 64)
    enc = vae.encoder
    assert enc.use_kernel()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, VOCAB, (6, 24)).astype(np.int32)
    w = rng.standard_normal((2, 6, Z)).astype(np.float32)
    params = vae.params()["encoder"]
    wt = torch.from_numpy(w)

    def loss(p):
        d = enc.apply(p, torch.from_numpy(tokens))
        return (d.loc * wt[0]).sum() + (d.scale * wt[1]).sum()

    before = encoder_kernel.encoder_hn.launches
    got = _grads_of(loss, params)
    assert encoder_kernel.encoder_hn.launches == before
    monkeypatch.setattr(enc, "use_kernel", lambda dtype=None: False)
    eager = _grads_of(loss, params)

    def jloss(p):
        d = jvae.encoder.apply(p, jnp.asarray(tokens), train=False)
        return jnp.sum(d.loc * w[0]) + jnp.sum(d.scale * w[1])

    gp = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, jvae.params["encoder"]))
    _assert_grads(got, eager, _leaves(gp))


def test_arnn_decode_gradient_is_the_eager_scans(open_jax_gates, monkeypatch):
    """K7's route under a gradient (the inpainting decode, forced ticks
    outside the span), back to every weight."""
    jm, pm = make_pair(64)
    params = pm.params()
    assert pm._use_kernel_decode(params)
    score, md, loc = make_batch(3, 48, span=(16, 32))
    w = np.random.default_rng(6).standard_normal((3, 48, 30)).astype(np.float32)
    wt = torch.from_numpy(w)
    args = [torch.from_numpy(a) for a in (score, md, loc)]

    def loss(p):
        return (pm.apply_inpaint(p, *args)[0] * wt).sum()

    before = arnn_sampled_decode.launches
    got = _grads_of(loss, params)
    assert arnn_sampled_decode.launches == before
    monkeypatch.setattr(pm, "_use_kernel_decode", lambda p: False)
    eager = _grads_of(loss, params)

    def jloss(p):
        lg, _ = jm.apply_inpaint(p, *map(jnp.asarray, (score, md, loc)), train=False,
                                 rng=jax.random.PRNGKey(1))
        return jnp.sum(lg * w)

    gp = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, jm.params))
    _assert_grads(got, eager, _leaves(gp))


def test_kernel_with_eager_grad_leaves_inference_alone():
    """No gradient asked: the wrapper is the kernel call itself (no graph);
    integer outputs never get one."""
    from inpaintnet_tpu_torch.ops.kernel_common import kernel_with_eager_grad

    calls = []

    def kernel(p, x):
        calls.append("kernel")
        return p["w"] * x, torch.zeros(3, dtype=torch.int32)

    def eager(p, x):
        calls.append("eager")
        return p["w"] * x, torch.zeros(3, dtype=torch.int32)

    fn = kernel_with_eager_grad(kernel, eager)
    w = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    x = torch.tensor([4.0, 5.0, 6.0])
    with torch.no_grad():
        out, tok = fn({"w": w}, x)
    assert out.grad_fn is None and calls == ["kernel"]
    out, tok = fn({"w": w, "n": 3, "none": None}, x)
    assert not tok.requires_grad and calls == ["kernel", "kernel"]
    out.sum().backward()
    assert calls == ["kernel", "kernel", "eager"]
    torch.testing.assert_close(w.grad, x)


# --------------------------------------------------------------------------- #
# The f32 routes' plans
# --------------------------------------------------------------------------- #
H100_DECODE_F32_SLOTS = {4: 30, 8: 15}  # an H100's clusters of 4 and 8 CTAs at once


def test_decode_f32_plan():
    """K2 f32: CTAs of whole 32-unit pairs of chunks with a ring of two or
    more 60 KB stages beside their f32 carries: 4 and 8 at the flagship's H
    512 (3 stages at 8, 2 at 4); at every row count of the engine (a
    batch-2048 call's 12,288, an autoregressive step's 2,048, a batch-1
    call's 6) an H100 takes 8."""
    dk = decode_kernel
    assert dk.f32_cluster_sizes(512) == [4, 8]
    assert [dk.f32_stages(512, c) for c in (4, 8)] == [2, 3]
    assert dk.f32_cluster_sizes(64) == [1, 2] and dk.f32_cluster_sizes(128) == [1, 2, 4]
    assert dk.f32_cluster_sizes(96) == []
    for rows in (12288, 2048, 6):
        plan = dk.f32_plan(rows, 512, 132, H100_DECODE_F32_SLOTS)
        assert plan == kc.LaunchPlan(8, 3), (rows, plan)
        assert dk.f32_smem_bytes(512, plan.cluster, plan.stages) <= kc.HOPPER_SMEM_BUDGET
    # fewer clusters of 8 than of 4 fit: at 60 tiles the cost model weighs waves
    assert dk.f32_plan(64 * 60, 512, 132, {4: 30, 8: 8}).cluster == 4
    with pytest.raises(ValueError):
        dk.f32_plan(64, 96, 132)


def test_gru_layer_f32_plan():
    """K8 f32: 64 units a CTA (K5's f32 register budget), so H / 64 CTAs,
    16 at the generation GRU's H 1024 (a non-portable cluster); K5's ring
    of two 96 KB stages."""
    assert gk.f32_plan(512) == kc.LaunchPlan(8, 2)
    assert gk.f32_plan(1024) == kc.LaunchPlan(16, 2)
    assert gk.f32_plan(64) == kc.LaunchPlan(1, 2)
    for hidden in (96, 1088, 0):
        with pytest.raises(ValueError):
            gk.f32_plan(hidden)
    assert kc.gru_layer_supports_hidden(1024, torch.float32)


# --------------------------------------------------------------------------- #
# The f32 routes' weight pieces, as the kernels' TMA boxes read them
# --------------------------------------------------------------------------- #
def test_decode_f32_weight_pieces():
    """K2 f32's packed weights: block ((m * H / 32 + pair) * KB + k) * 6 +
    2 piece + chunk holds piece `piece` of weight m's columns g H + 16 (2
    pair + chunk) + u (row 16 g + u) at inputs 64 k + [0, 64); the head's
    blocks follow, its 96 zero-padded columns as chunks of 48. The three
    pieces sum to each f32 weight exactly."""
    hidden, vocab = 128, 60
    rng = np.random.default_rng(7)
    ws = [torch.from_numpy((0.2 * rng.standard_normal((hidden, 3 * hidden))).astype(np.float32))
          for _ in range(3)]
    head = torch.from_numpy(rng.standard_normal((hidden, vocab)).astype(np.float32))
    packed = decode_kernel.pack_decode_f32_weights(*ws, head)
    kb, pairs = hidden // 64, hidden // 32
    assert packed.shape == ((3 * pairs + 1) * kb * 6, 48, 64) and packed.dtype == torch.bfloat16
    blocks = packed.float().reshape(-1, 6, 48, 64)  # a k-slab's six blocks: one TMA box
    summed = blocks.reshape(-1, 3, 2, 48, 64).sum(dim=1)  # hi + mid + lo
    for m, w in enumerate(ws):
        for pair in range(pairs):
            for k in range(kb):
                got = summed[(m * pairs + pair) * kb + k]  # (2 chunks, 48, 64)
                for chunk in range(2):
                    units = 16 * (2 * pair + chunk) + torch.arange(16)
                    cols = torch.cat([g * hidden + units for g in range(3)])
                    torch.testing.assert_close(got[chunk], w[64 * k:64 * k + 64, cols].t(),
                                               rtol=0, atol=0)
    head_t = torch.zeros((96, hidden))
    head_t[:vocab] = head.t()
    for k in range(kb):
        got = summed[3 * pairs * kb + k].reshape(96, 64)
        torch.testing.assert_close(got, head_t[:, 64 * k:64 * k + 64], rtol=0, atol=0)


def test_decode_f32_init_pieces():
    """The init hiddens' pieces a reset tick reads: (layer, beat, piece,
    rows padded to whole tiles, H), zero past the batch, summing to h_inits
    exactly."""
    h_inits = torch.randn(2, 70, 4, 64)
    init = decode_kernel.decode_f32_data(h_inits)
    assert init.shape == (2, 4, 3, 128, 64) and init.dtype == torch.bfloat16
    summed = init.float().sum(dim=2)
    torch.testing.assert_close(summed[:, :, :70], h_inits.transpose(1, 2), rtol=0, atol=0)
    assert not summed[:, :, 70:].any()


def test_gru_layer_f32_weight_pieces():
    """K8 f32 streams K5's packing: element [p, c, k, 32 g + u, kk] is piece
    p of W_hh[64 k + kk, g H + 32 c + u] (one 5-D TMA box a k-slab of a
    CTA's chunks in every piece), the pieces summing to W_hh exactly."""
    hidden = 128
    w = torch.from_numpy((0.3 * np.random.default_rng(8).standard_normal((hidden, 3 * hidden)))
                         .astype(np.float32))
    packed = pack_fwd_weights(w)
    assert packed.shape == (3, hidden // 32, hidden // 64, 96, 64)
    summed = packed.float().sum(dim=0)
    for c in range(hidden // 32):
        cols = torch.cat([g * hidden + 32 * c + torch.arange(32) for g in range(3)])
        for k in range(hidden // 64):
            torch.testing.assert_close(summed[c, k], w[64 * k:64 * k + 64, cols].t(),
                                       rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# The f32 routes' arithmetic, emulated on split_product
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def decode_case():
    """K2's inputs at H 64 (13 rows: not a multiple of the JAX kernel's
    8-row tile), the plain version's and the JAX kernel's outputs."""
    _, params, tick_ctx, h_inits = decode_setup(13, hidden=64, seed=5)
    args = (_torch(params), _torch(tick_ctx), _torch(h_inits))
    pw, ps = decode_sampling_pallas(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    jax_out = (torch.from_numpy(np.asarray(pw)), torch.from_numpy(np.asarray(ps)))
    return args, decode_kernel.decode_sampling_reference(*args), jax_out


@pytest.mark.parametrize("pieces", [3, 1])
def test_decode_split_emulation(decode_case, monkeypatch, pieces):
    """K2 f32's products as the split passes: within the f32 bounds of the
    plain version and of the JAX kernel; on one bf16 piece of h, outside."""
    args, plain, jax_out = decode_case
    monkeypatch.setattr(decode_kernel, "tick_product",
                        lambda h, w: kc.split_product(h, w, pieces=pieces))
    got = decode_kernel.decode_sampling_reference(*args)
    for want in (plain, jax_out):
        agree = decode_kernel.agreement(got, want)
        assert decode_kernel.within(agree) == (pieces == 3), agree


def test_decode_reset_fault_breaks_the_bounds(decode_case, monkeypatch):
    """A reset tick whose products take the previous tick's h instead of
    the beat's init hidden (the split operand's trap)."""
    args, plain, _ = decode_case
    monkeypatch.setattr(decode_kernel, "beat_operand", lambda init, prev: prev)
    agree = decode_kernel.agreement(decode_kernel.decode_sampling_reference(*args), plain)
    assert not decode_kernel.within(agree), agree


def test_decode_sum_order_fault_is_seen_with_cancelling_biases(decode_case, monkeypatch):
    """The fault "one accumulator" moves layer 1 by a rounding only, below
    the f32 bounds. With cancelling biases on layer 1 the plain version's
    order rounds (x + b_ih1) and (h + b_hh1) on their own: the split
    emulation (the kernel's arithmetic, its sums in another order) stays
    close to it, the one-accumulator order moves most elements by up to half
    an ulp of the shift, and the mean logit error tells them apart. Seen
    at H 64, 13 rows, two seeds: the emulation 1.05e-7 / 1.03e-7, the fault
    3.65e-6 / 4.21e-6 (35x, 41x; 2.5-2.9x at a shift of 64, 7.5-8.2x at
    256)."""
    args, _, _ = decode_case
    args = (decode_kernel.cancelling_layer1_biases(args[0], decode_kernel.SUM_ORDER_SHIFT),
            *args[1:])
    plain = decode_kernel.decode_sampling_reference(*args)
    monkeypatch.setattr(decode_kernel, "tick_product", lambda h, w: kc.split_product(h, w))
    kernel = decode_kernel.agreement(decode_kernel.decode_sampling_reference(*args), plain)
    monkeypatch.setattr(decode_kernel, "layer1_preacts", decode_kernel.one_accumulator_preacts)
    fault = decode_kernel.agreement(decode_kernel.decode_sampling_reference(*args), plain)
    assert fault["mean"] > decode_kernel.SUM_ORDER_RATIO * kernel["mean"], (kernel, fault)


K8_CASES = [  # batch, steps, hidden, mask, reverse, want_ys
    (13, 10, 64, "suffix", True, True),
    (13, 10, 64, "interior", False, True),
    (5, 7, 128, "zero_rows", True, False),
]


@pytest.mark.parametrize("pieces", [3, 1])
@pytest.mark.parametrize("batch,steps,hidden,mask,reverse,want_ys", K8_CASES)
def test_gru_layer_split_emulation(monkeypatch, pieces, batch, steps, hidden, mask, reverse,
                                   want_ys):
    """K8 f32's product as the split passes (the held steps as the plain
    version's): within ``BOUNDS[float32]`` of the plain version and of the
    JAX kernel; on one bf16 piece of h, outside."""
    arrays = _case(batch, steps, hidden, mask, 3 * batch + steps + hidden)
    args = [None if a is None else torch.from_numpy(a) for a in arrays]
    plain = gk.gru_layer_reference(*args, reverse=reverse, want_ys=want_ys)
    jax_out = _to_torch(gru_layer_pallas_stream(*_jax(arrays, jnp.float32), reverse=reverse,
                                                tile_b=8, interpret=True, want_ys=want_ys),
                        torch.float32)
    monkeypatch.setattr(gk, "layer_product", lambda h, w: kc.split_product(h, w, pieces=pieces))
    got = gk.gru_layer_reference(*args, reverse=reverse, want_ys=want_ys)
    for want in (plain, jax_out):
        agree = gk.agreement(got, want)
        assert gk.within(agree, gk.BOUNDS[torch.float32]) == (pieces == 3), agree


def test_gru_layer_held_pieces_fault_breaks_the_bound():
    """A held row that writes no pieces: where a row runs after a hold (a
    reverse layer over suffix masks, interior zeros), its product reads
    stale pieces and the bound rejects it; a row held from the first step
    of a forward layer never runs again, so there it changes nothing."""
    arrays = _case(13, 10, 64, "interior", 11)
    args = [torch.from_numpy(a) for a in arrays]
    for reverse in (False, True):
        agree = gk.agreement(gk.held_pieces_fault_reference(*args, reverse=reverse),
                             gk.gru_layer_reference(*args, reverse=reverse))
        assert not gk.within(agree, gk.BOUNDS[torch.float32]), agree
    arrays = _case(13, 10, 64, "suffix", 12)
    args = [torch.from_numpy(a) for a in arrays]
    fwd = gk.agreement(gk.held_pieces_fault_reference(*args), gk.gru_layer_reference(*args))
    assert fwd["max_abs_err"] == 0.0
    rev = gk.agreement(gk.held_pieces_fault_reference(*args, reverse=True),
                       gk.gru_layer_reference(*args, reverse=True))
    assert not gk.within(rev, gk.BOUNDS[torch.float32]), rev
