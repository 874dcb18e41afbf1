"""K8, K5 and K6 above 1,024 units: tile groups whose CTAs span clusters
(``kernel_common.tile_plan``), and the LatentRNN of hidden 768 whose
generation GRU is 1,536 wide.

On the CPU:
- the plan's choices on a card of 132 SMs holding one CTA an SM: the
  cluster route up to 1024, tile groups above (G CTAs a tile, the groups
  at once), one launch a step just above what the card holds; the widths
  a layer runs at (odd counts of 128-unit blocks one block wider);
- the JAX package's kernels (interpret mode, as its own tests run them) at
  H 1088 and 1536, B 8, T 3, against the port's plain versions on the
  wrappers' padded operands, sliced back, in f32; the same plain versions
  against themselves at H in float64 (exact);
- the 768 LatentRNN against the JAX one, its weights carried by
  ``models/convert.py``: ``apply`` non-autoregressively and
  autoregressively with JAX's noise injected, and the autoregressive
  sampled branch's loss and gradients through the trainfast Function.

On the card (``-m cuda``; imports no JAX):

    python -m pytest tests/test_torch_wide_layers.py -m cuda -q --noconftest

K8, K5 and K6 in both dtypes at H 1088 (padded where a dtype needs it),
1536, 2048 and 4096 and one width in step mode against their plain versions
with launch counts; the group route forced at H 1024 bit-equal to the
cluster route; the step route bit-equal to the group route; the two
planted faults of the exchange rejected; the trainfast gradient at 1536
against the eager loop.
"""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import gru as gru_mod
from inpaintnet_tpu_torch.ops import gru_kernel as lk
from inpaintnet_tpu_torch.ops import gru_train_kernel as tk
from inpaintnet_tpu_torch.ops import kernel_common as kc
from inpaintnet_tpu_torch.ops.gru import gru_init

from test_torch_cuda_kernels import (  # noqa: F401  (cuda: the card's fixture)
    TRAIN_BOUNDS,
    _errs,
    _gru_layer_case,
    _train_case,
    cuda,
)

EXACT = 1e-12  # float64: the zero units add exact zeros
# f32, the JAX kernels (interpret mode) against the plain versions: both
# accumulate products of 1,088-1,536 terms in f32 in other orders. K8 as
# tests/test_torch_gru_layer.py at H 64-128 (2e-5) scaled by the deeper sums;
# K5/K6 (max, mean) of |diff| / (1 + |want|), as TRAIN_BOUNDS in f32
K8_F32 = 5e-5
K5_K6_F32 = (1e-4, 1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# The plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K5", "K6", "K8"])
def test_plan_choices_on_132_sms(dtype, kernel):
    """2,048 rows (32 tiles) on 132 SMs, one CTA an SM: the cluster route up
    to 1024 units; above, a group of H / units CTAs (K5 and K8: 64 units in
    f32, 128 in bf16; K6: 128) and as many groups at once as 132 CTAs hold;
    one launch a step where a group is more than 132 CTAs."""
    units = kc.tile_units(dtype, kernel)
    assert units == (64 if kernel != "K6" and dtype == torch.float32 else 128)
    for hidden in (512, 1024):
        assert kc.tile_plan(2048, hidden, dtype, kernel=kernel).route == "cluster"
    for hidden in (1152, 1536, 2048, 4096):
        ctas = hidden // units
        assert kc.tile_plan(2048, hidden, dtype, kernel=kernel) == kc.TilePlan(
            "group", ctas, min(32, 132 // ctas))
    ceiling = 132 * units  # the widest group the card holds at once
    assert kc.tile_plan(2048, ceiling, dtype, kernel=kernel) == kc.TilePlan(
        "group", 132, 1)
    assert kc.tile_plan(2048, ceiling + units, dtype, kernel=kernel) == kc.TilePlan(
        "step", 133, 32)
    assert kc.tile_plan(1, 1536, dtype, kernel=kernel).groups == 1  # one tile: one group
    # a card holding two CTAs an SM doubles the ceiling
    assert kc.tile_plan(64, ceiling + units, dtype, resident=264, kernel=kernel).route == "group"
    with pytest.raises(ValueError):
        kc.tile_plan(2048, ceiling + units, dtype, kernel=kernel, route="group")


def test_plan_examples():
    """The widths of the 768 LatentRNN and the edges named in PERF.md."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert kc.tile_plan(2048, 1536, bf16) == kc.TilePlan("group", 12, 11)
    assert kc.tile_plan(2048, 1536, f32) == kc.TilePlan("group", 24, 5)
    assert kc.tile_plan(2048, 1088, f32) == kc.TilePlan("group", 17, 7)
    assert kc.tile_plan(2048, 8448, f32) == kc.TilePlan("group", 132, 1)
    assert kc.tile_plan(2048, 8512, f32) == kc.TilePlan("step", 133, 32)
    assert kc.tile_plan(2048, 16896, bf16, kernel="K6") == kc.TilePlan("group", 132, 1)
    assert kc.tile_plan(2048, 17024, bf16, kernel="K6") == kc.TilePlan("step", 133, 32)
    assert kc.tile_plan(2048, 1536, f32, route="step") == kc.TilePlan("step", 24, 32)
    with pytest.raises(ValueError):  # the cluster route is no forced route
        kc.tile_plan(2048, 1536, bf16, route="cluster")


@pytest.mark.parametrize("hidden,f32,bf16,train", [
    (1024, 1024, 1024, 1024), (1025, 1088, 1152, 1152), (1088, 1088, 1152, 1152),
    (1152, 1152, 1152, 1152), (1500, 1536, 1536, 1536), (1536, 1536, 1536, 1536),
    (2000, 2048, 2048, 2048), (4095, 4096, 4096, 4096), (8500, 8512, 8576, 8576),
    (20000, 20032, 20096, 20096)])
def test_widths_above_1024(hidden, f32, bf16, train):
    """K8 runs f32 at every multiple of 64 and bf16 at every multiple of 128
    above 1024 (an odd count of 128-unit blocks one block wider, on zero
    units); the trainfast Function at K6's multiples of 128 in both."""
    assert kc.gru_layer_width(hidden, torch.float32) == f32
    assert kc.gru_layer_width(hidden, torch.bfloat16) == bf16
    for dtype in (torch.float32, torch.bfloat16):
        assert tk.trainfast_width(hidden, dtype) == train
        assert kc.gru_layer_supports_hidden(hidden, dtype)
    assert tk.trainfast_supports(hidden)


# --------------------------------------------------------------------------- #
# The JAX kernels at H 1088 and 1536 against the plain versions
# --------------------------------------------------------------------------- #
@pytest.fixture
def float64_plain(monkeypatch):
    """``.float()`` keeps float64 (the plain versions' f32 upcast), as
    tests/test_torch_hidden_widths.py does, so the zero units show exact."""
    real = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda self, *a, **k: self if self.dtype == torch.float64
                        else real(self, *a, **k))


def _jnp(t):
    import jax.numpy as jnp

    return None if t is None else jnp.asarray(t.numpy())


def _np(x):
    return np.asarray(x, dtype=np.float64)


@pytest.mark.parametrize("hidden,dtype", [(1088, torch.float32), (1088, torch.bfloat16),
                                          (1536, torch.float32)])
def test_jax_k8_matches_plain_on_padded_operands(hidden, dtype):
    """``gru_layer_pallas_stream`` (interpret mode) in f32 against K8's plain
    version on the wrapper's padded operands (f32 at 1088 runs as it is,
    bf16's rule pads it to 1152), sliced back: suffix masks with an
    all-zero row, both directions, within ``K8_F32``."""
    from inpaintnet_tpu.ops.gru_pallas import gru_layer_pallas_stream

    args = _gru_layer_case(np.random.default_rng(hidden), 8, 3, hidden, torch.float32, "cpu",
                           "suffix")
    padded = kc.gru_layer_width(hidden, dtype)
    ops = lk.padded_operands(*args[:4], padded)
    assert ops[1].shape == (padded, 3 * padded)
    for reverse in (False, True):
        want = gru_layer_pallas_stream(*map(_jnp, args), reverse=reverse, tile_b=8,
                                       interpret=True)
        ys, hn = lk.gru_layer_reference(*ops, args[4], reverse=reverse)
        got = (kc.unpad_units(ys, hidden, padded), kc.unpad_units(hn, hidden, padded))
        for g, w in zip(got, want):
            assert np.abs(_np(g) - _np(w)).max() <= K8_F32


@pytest.mark.parametrize("hidden", [1088, 1536])
def test_jax_k5_k6_match_plain_on_padded_operands(hidden):
    """``gru_fwd_seq_pallas`` and ``gru_bwd_seq_pallas`` (interpret mode) in
    f32 against K5's and K6's plain versions as the trainfast Function calls
    them (at ``trainfast_width``: 1088 at 1152, on zero units; K6 on K5's
    padded residuals), sliced back, both directions, within ``K5_K6_F32``;
    W_hh at Xavier's scale (at 0.3 a recurrence this wide is chaotic)."""
    from inpaintnet_tpu.ops.gru_bwd_pallas import gru_bwd_seq_pallas, gru_fwd_seq_pallas

    fwd, dys, hprev = _train_case(np.random.default_rng(hidden), 8, hidden, 3, torch.float32,
                                  "cpu")
    fwd[0] = fwd[0] * ((2.0 / (4 * hidden)) ** 0.5 / 0.3)
    width = tk.trainfast_width(hidden, torch.float32)
    padded = tk.fwd_padded_operands(*fwd)
    assert padded[0].shape == (width, 3 * width)
    for reverse in (False, True):
        jf = gru_fwd_seq_pallas(*map(_jnp, fwd), reverse=reverse, tile_b=8, interpret=True)
        out_p = tk.gru_fwd_seq_reference(*padded, reverse=reverse)
        out = [kc.unpad_units(o, hidden, width) for o in out_p]
        err = _errs(out, [torch.from_numpy(_np(j)) for j in jf])
        assert err[0] <= K5_K6_F32[0] and err[1] <= K5_K6_F32[1], err
        jb = gru_bwd_seq_pallas(_jnp(fwd[0]), _jnp(dys), *map(_jnp, out[1:]), _jnp(hprev),
                                reverse=reverse, tile_b=8, interpret=True)
        got = tk.gru_bwd_seq_reference(padded[0], kc.pad_units(dys, hidden, width), *out_p[1:],
                                       kc.pad_units(hprev, hidden, width), reverse=reverse)
        got = [kc.unpad_units(got[0], hidden, width, 3), kc.unpad_units(got[1], hidden, width, 3),
               kc.unpad_units(got[2], hidden, width)]
        err = _errs(got, [torch.from_numpy(_np(j)) for j in jb])
        assert err[0] <= K5_K6_F32[0] and err[1] <= K5_K6_F32[1], err


@pytest.mark.parametrize("hidden", [1088, 1100])
def test_plain_versions_on_zero_units_are_exact_above_1024(float64_plain, hidden):
    """In float64, K8's plain version on bf16's padded operands (1152) and
    K5's and K6's on the trainfast Function's, sliced back, equal the plain
    versions at H within 1e-12; the padded units stay 0."""
    args = _gru_layer_case(np.random.default_rng(hidden), 8, 3, hidden, torch.float64, "cpu",
                           "target")
    width = kc.gru_layer_width(hidden, torch.bfloat16)
    ys, hn = lk.gru_layer_reference(*lk.padded_operands(*args[:4], width), args[4],
                                    reverse=True)
    want = lk.gru_layer_reference(*args, reverse=True)
    assert not ys[..., hidden:].any() and not hn[..., hidden:].any()
    for g, w in zip((kc.unpad_units(ys, hidden, width), kc.unpad_units(hn, hidden, width)), want):
        assert (g - w).abs().max().item() <= EXACT
    fwd, dys, hprev = _train_case(np.random.default_rng(hidden), 8, hidden, 3, torch.float64,
                                  "cpu")
    width = tk.trainfast_width(hidden, torch.float64)
    out_p = tk.gru_fwd_seq_reference(*tk.fwd_padded_operands(*fwd, width))
    out = tk.gru_fwd_seq_reference(*fwd)
    for g, w in zip(out_p, out):
        assert (kc.unpad_units(g, hidden, width) - w).abs().max().item() <= EXACT
    got = tk.gru_bwd_seq_reference(tk.fwd_padded_operands(*fwd, width)[0],
                                   kc.pad_units(dys, hidden, width), *out_p[1:],
                                   kc.pad_units(hprev, hidden, width))
    want = tk.gru_bwd_seq_reference(fwd[0], dys, *out[1:], hprev)
    for g, w, groups in zip(got, want, (3, 3, 1)):
        assert (kc.unpad_units(g, hidden, width, groups) - w).abs().max().item() <= EXACT


# --------------------------------------------------------------------------- #
# The 768 LatentRNN against the JAX one
# --------------------------------------------------------------------------- #
LATENT_HIDDEN = 768  # train_inpaintnet.py --latent_rnn_hidden_size 768: a 1,536 generation GRU
LATENT_ATOL = 1e-4  # f32 end to end, as tests/test_torch_latent_rnn_autoreg.py


@pytest.fixture(scope="module")
def jax_vae16():
    """The JAX MeasureVAE of hidden 16 (vocab 30, z 12) with jittered
    parameters, made once for both 768 LatentRNN tests."""
    import jax

    from inpaintnet_tpu.models.measure_vae import MeasureVAE as JaxMeasureVAE
    from inpaintnet_tpu.models.presets import VocabOnlyDataset as JaxVocabOnlyDataset
    from test_torch_latent_rnn_autoreg import EMB, VOCAB, Z

    vae = JaxMeasureVAE(JaxVocabOnlyDataset(VOCAB), note_embedding_dim=EMB, num_encoder_layers=2,
                        encoder_hidden_size=16, latent_space_dim=Z, num_decoder_layers=2,
                        decoder_hidden_size=16)
    vae.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    vae.params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        vae.params)
    return vae


@pytest.mark.parametrize("auto_reg", [False, True], ids=["parallel", "autoregressive"])
def test_latent_rnn_768_matches_jax(jax_vae16, auto_reg):
    """The JAX LatentRNN of hidden 768 over a narrow VAE (hidden 16), its
    weights carried into the port by ``from_jax_params``: ``apply`` on the
    ``"pallas"`` route (K8's plain version at 768 and 1,536 on the CPU),
    JAX's context and re-encode noise injected; z within 1e-4, tokens
    equal."""
    import jax

    from inpaintnet_tpu.models.latent_rnn import LatentRNN as JaxLatentRNN
    from inpaintnet_tpu.models.presets import VocabOnlyDataset as JaxVocabOnlyDataset
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset, build_latent_rnn
    from test_torch_latent_rnn_autoreg import EMB, MT, VOCAB, Z, _compare

    jvae = jax_vae16
    wide = JaxLatentRNN(JaxVocabOnlyDataset(VOCAB), jvae, num_rnn_layers=2,
                        rnn_hidden_size=LATENT_HIDDEN, dropout=0.5, auto_reg=auto_reg,
                        max_target=MT)
    wide.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    wide.params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        wide.params)
    model = build_latent_rnn(VocabOnlyDataset(VOCAB), emb=EMB, hidden=16, z_dim=Z, layers=2,
                             vae_params_np=jvae.params, latent_params_np=wide.params,
                             auto_reg=auto_reg, device="cpu", latent_hidden=LATENT_HIDDEN)[1]
    assert model.gen_hidden_size == 2 * LATENT_HIDDEN
    _compare(jvae, wide, model, seed=4, impl="pallas")


def test_latent_rnn_768_sampled_branch_loss_and_grads_match_jax():
    """The autoregressive LatentRNN of hidden 768 (VAE hidden 16) on its
    sampled branch: the unmasked 1,536-wide generation GRU runs the
    trainfast Function (K5/K6's plain versions here, one K5 call each
    layer-direction a target step), the loss and every gradient against
    the JAX trainer's with JAX's noise and coin injected: loss within
    2e-5, gradients within 1e-4 (f32 sums of 1,536-deep products in another
    order through a loop of GRUs and re-encodes)."""
    import jax

    from inpaintnet_tpu.models.latent_rnn import LatentRNN as JaxLatentRNN
    from inpaintnet_tpu_torch.models import latent_rnn as tlr
    from inpaintnet_tpu_torch.models.base import flatten_params
    from test_torch_latent_rnn_train import (DATA, LOSS_ATOL, MT, _coin_key, _inject,
                                             _jax_trainer, _jax_value_and_grad, _models,
                                             _port_value_and_grad, _split)

    jvae, _, small = _models(auto_reg=True)
    jmodel = JaxLatentRNN(DATA, jvae, num_rnn_layers=2, rnn_hidden_size=LATENT_HIDDEN,
                          dropout=0.0, auto_reg=True, max_target=MT)
    jmodel.init(jax.random.PRNGKey(9))
    rng = np.random.default_rng(9)
    jmodel.params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(np.shape(x))).astype(np.float32),
        jmodel.params)
    vae = small.vae_model  # the JAX VAE's parameters, as _models carried them
    model = tlr.LatentRNN(vae, 2, LATENT_HIDDEN, True, MT, "cpu", dropout=0.0, dataset=DATA)
    model.set_params(jmodel.params)
    jtr = _jax_trainer(jmodel)
    key = _coin_key(False)
    batch = _split(jtr, 1)
    v, g = _jax_value_and_grad(jtr, jvae, jmodel.params, batch, key)
    calls = []
    real = tk.gru_fwd_seq_reference
    tk.gru_fwd_seq_reference = lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k)
    try:
        got_v, got = _port_value_and_grad(model, batch, _inject(model, key, False))
    finally:
        tk.gru_fwd_seq_reference = real
    assert calls.count(2 * LATENT_HIDDEN) >= 4  # the generation GRU on the trainfast Function
    want = flatten_params(g)
    np.testing.assert_allclose(got_v, float(v), rtol=0, atol=LOSS_ATOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
CARD_WIDTHS = [1088, 1536, 2048, 4096]


def _route(monkeypatch, route):
    """Every K5, K6 and K8 launch on ``route`` (``kernel_common.card_tile_plan``
    reads ``tile_route``)."""
    monkeypatch.setattr(kc, "tile_route", lambda: route)


def _fault(monkeypatch, fault):
    """A planted fault in every tile-group launch (the wrappers import
    ``group_fault`` by name)."""
    for module in (kc, lk, tk):
        monkeypatch.setattr(module, "group_fault", lambda: fault)


def _same(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def _k8(cuda, hidden, dtype, rows=70, steps=4, seed=0):
    return _gru_layer_case(np.random.default_rng(hidden + seed), rows, steps, hidden, dtype,
                           cuda, "suffix")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", CARD_WIDTHS)
def test_k8_above_1024_matches_plain(cuda, dtype, hidden):
    """K8 on tile groups (bf16 1088 at 1152 on zero units) against its plain
    version within ``gru_kernel.BOUNDS``, both directions, suffix masks
    with an all-zero row (which returns h0), one launch a call."""
    args = _k8(cuda, hidden, dtype)
    for reverse in (False, True):
        before = lk.gru_layer_stream.launches
        got = lk.gru_layer_stream(*args, reverse=reverse)
        want = lk.gru_layer_reference(*args, reverse=reverse)
        torch.cuda.synchronize()
        assert lk.gru_layer_stream.launches == before + 1
        agree = lk.agreement(got, want)
        assert lk.within(agree, lk.BOUNDS[dtype]), (hidden, dtype, reverse, agree)
        held = args[4].sum(dim=1) == 0
        assert torch.equal(got[1][held], args[3][held])


def _xavier(fwd, hidden):
    fwd[0] = (fwd[0].float() * ((2.0 / (4 * hidden)) ** 0.5 / 0.3)).to(fwd[0].dtype)
    return fwd


def _k5_k6(cuda, hidden, dtype, rows=70, steps=4):
    fwd, dys, hprev = _train_case(np.random.default_rng(hidden), rows, hidden, steps, dtype, cuda)
    return _xavier(fwd, hidden), dys, hprev


def _within_train(got, want, dtype):
    err = _errs(got, want)
    return err[0] <= TRAIN_BOUNDS[dtype][0] and err[1] <= TRAIN_BOUNDS[dtype][1], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", CARD_WIDTHS)
def test_k5_k6_above_1024_match_plain(cuda, dtype, hidden):
    """K5 and K6 on tile groups at the trainfast Function's width (1088 at
    1152) against their plain versions within ``TRAIN_BOUNDS``, both
    directions, one launch each."""
    width = tk.trainfast_width(hidden, dtype)
    fwd, dys, hprev = _k5_k6(cuda, width, dtype)
    for reverse in (False, True):
        before = (tk.gru_fwd_seq.launches, tk.gru_bwd_seq.launches)
        out = tk.gru_fwd_seq(*fwd, reverse=reverse)
        grads = tk.gru_bwd_seq(fwd[0], dys, *out[1:], hprev, reverse=reverse)
        want_out = tk.gru_fwd_seq_reference(*fwd, reverse=reverse)
        want_grads = tk.gru_bwd_seq_reference(fwd[0], dys, *out[1:], hprev, reverse=reverse)
        torch.cuda.synchronize()
        assert (tk.gru_fwd_seq.launches, tk.gru_bwd_seq.launches) == (before[0] + 1,
                                                                       before[1] + 1)
        for got, want in ((out, want_out), (grads, want_grads)):
            ok, err = _within_train(got, want, dtype)
            assert ok, (hidden, dtype, reverse, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_route_at_1024_is_the_cluster_route(cuda, monkeypatch, dtype):
    """At H 1024 the group route forced (the same CTAs, meeting at a global
    counter instead of a cluster's mbarrier) gives the cluster route's
    outputs bit for bit: K5 and K6 in both dtypes, K8 in f32 (K8 bf16's
    cluster route is another kernel)."""
    fwd, dys, hprev = _k5_k6(cuda, 1024, dtype, rows=130, steps=5)
    args = _k8(cuda, 1024, dtype, rows=130, steps=5)
    runs = {}
    for route in (None, "group"):
        with monkeypatch.context() as m:
            _route(m, route)
            out = tk.gru_fwd_seq(*fwd, reverse=True)
            runs[route] = (out, tk.gru_bwd_seq(fwd[0], dys, *out[1:], hprev, reverse=True),
                           lk.gru_layer_stream(*args) if dtype == torch.float32 else ())
    torch.cuda.synchronize()
    for a, b in zip(runs[None], runs["group"]):
        assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_route_is_the_group_route(cuda, monkeypatch, dtype):
    """One launch a step (forced at H 1536) gives the group route's outputs
    bit for bit, K8 with masks in both directions, K5 and K6: the carry
    between launches is the kernel's own (f32; K8 bf16's rounded to bf16)."""
    fwd, dys, hprev = _k5_k6(cuda, 1536, dtype, rows=70, steps=4)
    args = _k8(cuda, 1536, dtype, rows=70, steps=4)
    runs = {}
    for route in ("group", "step"):
        with monkeypatch.context() as m:
            _route(m, route)
            out = tk.gru_fwd_seq(*fwd)
            runs[route] = (out, tk.gru_bwd_seq(fwd[0], dys, *out[1:], hprev),
                           lk.gru_layer_stream(*args, reverse=True),
                           lk.gru_layer_stream(*args, want_ys=False))
    torch.cuda.synchronize()
    for a, b in zip(runs["group"], runs["step"]):
        assert _same(a, b)


@pytest.mark.cuda
def test_group_route_replays_in_a_cuda_graph(cuda):
    """K8 bf16 at H 1536 on the group route (a cooperative launch) captured
    into a CUDA graph, as the engines serve it: the replay gives the eager
    call's outputs bit for bit."""
    args = _k8(cuda, 1536, torch.bfloat16)
    want = lk.gru_layer_stream(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = lk.gru_layer_stream(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.cuda
def test_group_grid_past_the_card_is_refused(cuda, monkeypatch):
    """K8 bf16 at H 1536 on one tile group more than the card holds at once
    (the plan forced): the cooperative launch refuses the grid
    (cudaErrorCooperativeLaunchTooLarge, 720) instead of leaving a group to
    wait on a peer that never starts, and the card runs the next launch."""
    dtype = torch.bfloat16
    full = lk.tile_plan_of(64 * 64, 1536, dtype, cuda)  # as many groups as the card holds
    args = _k8(cuda, 1536, dtype, rows=64 * (full.groups + 1), steps=2)
    with monkeypatch.context() as m:
        m.setattr(lk, "tile_plan_of", lambda *a: kc.TilePlan("group", full.ctas, full.groups + 1))
        with pytest.raises(RuntimeError, match="cudaError_t 720$"):
            lk.gru_layer_stream(*args)
    agree = lk.agreement(lk.gru_layer_stream(*args), lk.gru_layer_reference(*args))
    assert lk.within(agree, lk.BOUNDS[dtype]), agree


@pytest.mark.cuda
def test_step_mode_past_what_the_card_holds(cuda):
    """K8 and K5 in f32 at H 8512: 133 CTAs of 64 units, one more than an
    H100 holds at once, so the plan runs one launch a step; against the
    plain versions (K8 on 8 rows, 2 steps, target masks)."""
    hidden = 8512
    plan = lk.tile_plan_of(8, hidden, torch.float32, cuda)
    assert plan.route == "step", plan
    args = _gru_layer_case(np.random.default_rng(1), 8, 2, hidden, torch.float32, cuda, "target")
    before = lk.gru_layer_stream.launches
    got = lk.gru_layer_stream(*args)
    want = lk.gru_layer_reference(*args)
    torch.cuda.synchronize()
    assert lk.gru_layer_stream.launches == before + 1
    assert lk.within(lk.agreement(got, want), lk.BOUNDS[torch.float32])
    fwd, _, _ = _k5_k6(cuda, hidden, torch.float32, rows=8, steps=2)
    ok, err = _within_train(tk.gru_fwd_seq(*fwd), tk.gru_fwd_seq_reference(*fwd), torch.float32)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [1, 2], ids=["other_parity", "count_short"])
def test_planted_exchange_faults_are_rejected(cuda, monkeypatch, fault):
    """The group's exchange planted wrong: a consumer reading the other
    parity buffer's pieces, or counting one arrival short while the last
    CTA is late: K8, K5 and K6 at H 1536 in f32 leave their bounds."""
    args = _k8(cuda, 1536, torch.float32, steps=6)
    fwd, dys, hprev = _k5_k6(cuda, 1536, torch.float32, steps=6)
    want8 = lk.gru_layer_reference(*args)
    want5 = tk.gru_fwd_seq_reference(*fwd)
    want6 = tk.gru_bwd_seq_reference(fwd[0], dys, *want5[1:], hprev)
    _fault(monkeypatch, fault)
    got8 = lk.gru_layer_stream(*args)
    got5 = tk.gru_fwd_seq(*fwd)
    got6 = tk.gru_bwd_seq(fwd[0], dys, *want5[1:], hprev)
    torch.cuda.synchronize()
    assert not lk.within(lk.agreement(got8, want8), lk.BOUNDS[torch.float32])
    assert not _within_train(got5, want5, torch.float32)[0]
    assert not _within_train(got6, want6, torch.float32)[0]


@pytest.mark.cuda
def test_trainfast_gradient_at_1536_matches_the_eager_loop(cuda, monkeypatch):
    """The trainfast Function at H 1536 in f32 (K5 and K6 on tile groups)
    against autograd through the eager loop on the card: loss and every
    gradient, with the bounds of
    ``test_torch_hidden_widths.test_trainfast_at_every_width_on_card_matches_cpu``."""
    hidden = 1536
    rng = np.random.default_rng(5)
    p = {k: v + 0.02 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in gru_init(rng, 20, hidden, 1)[0][0].items()}
    x = rng.standard_normal((37, 6, 20)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((37, hidden))).astype(np.float32)
    wy = torch.from_numpy(rng.standard_normal((37, 6, hidden)).astype(np.float32)).to(cuda)

    def run():
        tp = {k: torch.from_numpy(v).to(cuda).requires_grad_() for k, v in p.items()}
        tx, th0 = (torch.from_numpy(a).to(cuda).requires_grad_() for a in (x, h0))
        ys, h_last = gru_mod.gru_layer_apply(tp, tx, th0, train=True)
        loss = (ys * wy).sum() + h_last.sum()
        loss.backward()
        return [loss.detach()] + [tp[k].grad for k in sorted(tp)] + [tx.grad, th0.grad]

    before = (tk.gru_fwd_seq.launches, tk.gru_bwd_seq.launches)
    fast = run()
    torch.cuda.synchronize()
    assert (tk.gru_fwd_seq.launches, tk.gru_bwd_seq.launches) == (before[0] + 1, before[1] + 1)
    monkeypatch.setattr(gru_mod, "trainfast_supports", lambda h: False)
    eager = run()
    for got, want in zip(fast, eager):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
