"""K1-K4 above 512 units in bf16 masters, to the JAX kernels' VMEM gates:
the encoder's K1/K3 to H 577 (run at 576 or 640), the decode's K2/K4 to H
717 (run at 576, 640 or 768, on zero units).

- the plans at every new width (``encoder_consumers``, K2's and K4's
  clusters, boxes and stages): two ring stages or more within the shared
  memory budget, and, up to 512 units, the plans K8's helpers gave before;
- the widths and gates: f32 masters, and int8 on f32 masters, above 512
  run the eager loop and raise nowhere, bf16 masters take the kernels;
- each plain version on the wrappers' padded operands (577 -> 640, 717 ->
  768), sliced back, against the plain version at H: float64 within 1e-12,
  K3's and K4's bit-equal in bf16 masters, and the gate-major layout
  (``kernel_common.gate_padding``) rejected;
- the port's encoder and decode at H 576 against the JAX package's models
  on the CPU (its XLA scans there) at the existing bf16 bounds;
- on the card (``-m cuda``): K1 (and its training mode) at 576 and
  577, K3 refusing both and at 527 (run at 576), K2 and K4 at 576, 640, 704, 717 and 768 at every cluster size
  against their plain versions, and an engine over a VAE whose encoder
  runs K1 at 640 and whose decoder is 640 wide, graph route against eager.

JAX is imported inside the tests that compare with it, so the card's tests
run on a machine without it:

    python -m pytest tests/test_torch_wide_widths.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import decode_kernel as dk
from inpaintnet_tpu_torch.ops import encoder_kernel as ek
from inpaintnet_tpu_torch.ops import gru_kernel as gk
from inpaintnet_tpu_torch.ops import kernel_common as kc

from test_torch_cuda_kernels import (  # noqa: F401  (cuda: the card's fixture)
    ATOL,
    _bit_equal,
    _decode_case,
    _encoder_int8_case,
    cuda,
)
from test_torch_hidden_widths import (  # noqa: F401  (float64_plain: a fixture)
    EXACT,
    _both_routes,
    _close,
    _encoder_case,
    float64_plain,
)

SMS = 132  # an H100 SXM
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# The plans at every new width
# --------------------------------------------------------------------------- #
# (H, elem bytes, consumer warpgroups): K1 bf16's two h tiles above 512
# leave room for two rings; K3's int8 tiles for all four
ENCODER_PLANS = [(576, 2, 2), (640, 2, 2), (576, 1, 4), (640, 1, 4), (512, 2, 4), (512, 1, 4)]


@pytest.mark.parametrize("hidden,elem,consumers", ENCODER_PLANS)
def test_encoder_plans_fit_shared_memory(hidden, elem, consumers):
    assert ek.encoder_consumers(hidden, elem) == consumers
    used = ek.encoder_rec_smem_bytes(hidden, elem, consumers)
    assert used <= kc.HOPPER_SMEM_BUDGET
    if consumers == 2:  # four would not fit
        assert ek.encoder_rec_smem_bytes(hidden, elem, 4) > kc.HOPPER_SMEM_BUDGET
    assert ek.REC_STAGES[elem] >= 2


# (H, K2's (cluster sizes, box halves, stages), K4's (plan, box halves))
DECODE_PLANS = [
    (576, ([3], 2, 3), (kc.LaunchPlan(3, 6), 2)),
    (640, ([2], 2, 2), (kc.LaunchPlan(2, 2), 4)),
    (768, ([2, 4], 1, 2), (kc.LaunchPlan(4, 2), 2)),
]


@pytest.mark.parametrize("hidden,k2,k4", DECODE_PLANS)
def test_decode_plans_at_the_new_widths(hidden, k2, k4):
    """K2's and K4's plans above 512 units: an odd cluster at 576 (nine
    blocks), one-slab boxes where two-slab ones leave one stage (K2 at 640,
    K4 at 768), half-slab boxes where one-slab ones do (K2 at 768); each
    plan within the budget with two stages or more, covering every (row,
    unit) once."""
    sizes, halves, stages = k2
    assert kc.decode_cluster_sizes(hidden) == sizes
    assert kc.decode_box_halves(hidden, 2, 2) == halves
    assert kc.decode_stages(hidden, 2, 2) == stages >= 2
    assert kc.decode_smem_bytes(hidden, 2, 2, stages) <= kc.HOPPER_SMEM_BUDGET
    plan4, halves4 = k4
    assert dk.int8_plan(hidden) == plan4 and kc.decode_box_halves(hidden, 4, 1) == halves4
    assert kc.decode_smem_bytes(hidden, 4, 1, plan4.stages) <= kc.HOPPER_SMEM_BUDGET
    for rows in (6, 2048, 12288):
        plan = dk.launch_plan(rows, hidden, SMS)
        assert plan.cluster in sizes and plan.stages == stages
        for p in (plan, plan4):
            blocks = kc.plan_blocks(rows, hidden, p)
            assert len(blocks) == -(-rows // 64) * p.cluster
            assert all(u1 - u0 == hidden // p.cluster and u0 % 64 == 0
                       for _, _, u0, u1 in blocks)
    with pytest.raises(ValueError, match="hidden size 704"):
        dk.launch_plan(64, 704, SMS)


@pytest.mark.parametrize("hidden", range(64, 513, 64))
def test_decode_plans_up_to_512_are_k8s(hidden):
    """Up to 512 units K2's and K4's plan helpers give what the shared
    helpers (K8's, unchanged) gave them before: the same cluster sizes,
    two-slab boxes where the blocks pair up, the same stages."""
    assert kc.decode_cluster_sizes(hidden) == kc.cluster_sizes(hidden)
    for tiles, elem in ((2, 2), (4, 1)):
        assert kc.decode_box_halves(hidden, tiles, elem) == 2 * kc.box_slabs(hidden)
        assert kc.decode_stages(hidden, tiles, elem) == kc.ring_stages(hidden, tiles, elem)
    assert dk.launch_plan(2048, hidden, SMS) == kc.recurrence_plan(2048, hidden, SMS, 2)
    assert ek.encoder_consumers(hidden, 2) == ek.encoder_consumers(hidden, 1) == 4


def test_k7_and_k8_keep_their_widths():
    """K1-K4's f32 width stays at 512 (``kernel_width``); K7 has its own
    (``arnn_width``: bf16 to 640, f32 to 512; tests/test_torch_arnn_widths.py);
    K8's plans and widths do not move: bf16 576 still has no cluster split
    of its own."""
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    assert kc.kernel_width(576) is None and kc.kernel_width(512) == 512
    assert ak.arnn_kernel_supports(576, 576, 256, 60, BF16)
    assert not ak.arnn_kernel_supports(576, 576, 256, 60, torch.float32)
    assert kc.cluster_sizes(576) == [] and kc.gru_layer_width(576, BF16) == 640
    assert gk.launch_plan(2048, 1024, SMS) == kc.LaunchPlan(4, 2)


# --------------------------------------------------------------------------- #
# The widths and the models' gates
# --------------------------------------------------------------------------- #
WIDTHS = [  # (H, K1/K3 bf16 width, K1/K3 gate, K2/K4 bf16 width, K2/K4 gate)
    (512, 512, True, 512, True), (513, 576, True, 576, True), (576, 576, True, 576, True),
    (577, 640, True, 640, True), (578, 640, False, 640, True), (640, 640, False, 640, True),
    (641, None, False, 768, True), (704, None, False, 768, True),
    (717, None, False, 768, True), (718, None, False, 768, False),
    (769, None, False, None, False)]


@pytest.mark.parametrize("hidden,enc_w,enc_gate,dec_w,dec_gate", WIDTHS)
def test_bf16_widths_and_gates(hidden, enc_w, enc_gate, dec_w, dec_gate):
    """bf16 masters: the width each wrapper runs H at and the models' gates
    (K1/K3 to 577, K2/K4 to 717); f32 masters keep 512 for both."""
    assert kc.encoder_width(hidden, BF16) == enc_w
    assert kc.decode_width(hidden, BF16) == dec_w
    assert kc.encoder_supports_hidden(hidden, BF16) == enc_gate
    assert kc.decode_supports_hidden(hidden, BF16) == dec_gate
    f32 = hidden <= 512
    assert kc.encoder_supports_hidden(hidden, torch.float32) == f32
    assert kc.decode_supports_hidden(hidden, torch.float32) == f32
    assert kc.encoder_supports_hidden(hidden) == kc.decode_supports_hidden(hidden) == f32
    assert dk.decode_supports(hidden, "int8", torch.float32) == f32
    assert dk.decode_supports(hidden, "int8") == (dec_w is not None)


def _port_models(enc_hidden: int, dec_hidden: int, dtype, seed: int = 0, vocab: int = 30):
    """A port Encoder and HierarchicalDecoder on the CPU with seeded random
    weights in ``dtype``."""
    from inpaintnet_tpu_torch.models.measure_vae import Encoder, HierarchicalDecoder

    enc = Encoder(8, enc_hidden, 2, vocab, 12, device="cpu")
    dec = HierarchicalDecoder(8, vocab, 12, 2, dec_hidden, device="cpu")
    rng = np.random.default_rng(seed)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return torch.from_numpy(np.asarray(t, np.float32)).to(dtype)
    return enc, tree(enc.init_params(rng)), dec, tree(dec.init_params(rng))


@pytest.mark.parametrize("hidden", [576, 704])
@pytest.mark.parametrize("dtype,quant", [(torch.float32, "none"), (torch.float32, "int8"),
                                         (BF16, "none"), (BF16, "int8")])
def test_gates_route_by_the_masters_dtype(monkeypatch, hidden, dtype, quant):
    """``Encoder.apply`` (inference, and training under K1's training-mode
    switch) and ``HierarchicalDecoder.decode_sampling`` at H 576 and 704:
    f32 masters, and int8 on f32 masters, run the eager loops (a kernel
    wrapper would raise) and return finite values; bf16 masters call the
    wrappers where the gates take the width (the encoder to 577, the decode
    to 717), the eager loops elsewhere, and int8 the int8 wrappers only
    where the JAX package quantizes (the encoder to 527)."""
    from inpaintnet_tpu_torch.models import measure_vae as mv

    enc, pe, dec, pd = _port_models(hidden, hidden, dtype)
    calls = []

    def recorder(name, real):
        def wrapper(*args, **kwargs):
            if dtype == torch.float32:
                raise AssertionError(f"{name} called with f32 masters at H {hidden}")
            calls.append(name)
            return real(*args, **kwargs)
        return wrapper

    for name in ("encoder_hn", "encoder_hn_int8", "decode_sampling_kernel",
                 "decode_sampling_int8"):
        monkeypatch.setattr(mv, name, recorder(name, getattr(mv, name)))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 30, (2, 24)).astype(np.int32))
    dist = enc.apply(pe, tokens, quant)
    z = dist.loc.detach()
    logits, samples = dec.decode_sampling(pd, z, quant)
    monkeypatch.setenv("INPAINTNET_TRAIN_ENCODER_IMPL", "pallas")
    train = enc.apply(pe, tokens, train=True, generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(t.float()).all()) for t in (z, logits, train.loc))
    assert samples.shape == (2, 24)
    enc_kernel = dtype == BF16 and hidden <= kc.ENCODER_MAX_HIDDEN
    # int8 quantizes only where the JAX package does: its encoder gate
    # closes above 527 in bf16 (K1 runs instead), its decode gate at V 30
    # is open at both widths
    enc_int8 = quant == "int8" and kc.encoder_quantizes(hidden, dtype)
    dec_int8 = quant == "int8" and kc.decode_quantizes(hidden, 30, dtype)
    assert not enc_int8 and dec_int8 == (quant == "int8" and dtype == BF16)
    want = ((["encoder_hn_int8" if enc_int8 else "encoder_hn"] if enc_kernel else [])
            + (["decode_sampling_int8" if dec_int8 else "decode_sampling_kernel"]
               if dtype == BF16 else [])
            + (["encoder_hn"] if enc_kernel else []))  # the training mode's forward
    assert calls == want
    assert enc.use_kernel(dtype) == enc_kernel and enc.use_train_kernel(dtype) == enc_kernel
    assert dec.use_kernel(dtype) == (dtype == BF16)
    assert not enc.use_kernel() and not dec.use_kernel()  # either dtype: 512


# --------------------------------------------------------------------------- #
# The plain versions on the padded operands, sliced back
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hidden,padded", [(577, 640), (576, 576)])
def test_plain_k1_k3_on_zero_units_at_wide_widths(float64_plain, hidden, padded):
    """K1's plain versions (inference, the training mode's mask, the staged
    route in chunks) on ``encoder_padded_operands`` at bf16's width (named:
    float64 takes the f32 rule), h_n sliced back: the plain versions at H
    within 1e-12; K3's int8 carries and bf16 h_n bit-equal at the width
    bf16 masters run (``encoder_width``)."""
    gru, table, tokens, keep = _encoder_case(hidden, torch.float64, batch=3)
    params, keep_p = ek.encoder_padded_operands(gru, keep, padded)
    assert params[0][0]["w_hh"].shape == (padded, 3 * padded)
    for run in (lambda g, k: ek.encoder_hn_reference(g, table, tokens),
                lambda g, k: ek.encoder_hn_reference(g, table, tokens, k, 0.3),
                lambda g, k: ek.encoder_hn_staged_reference(g, table, tokens, k, 0.3,
                                                            max_chunk_rows=2)):
        got = run(params, keep_p)
        assert not got[..., hidden:].any()
        _close([kc.unpad_units(got, hidden, padded)], [run(gru, keep)])
    gru, table, tokens, _ = _encoder_case(hidden, BF16, seed=1, batch=3)
    got, got_ys = ek.encoder_int8_layers_reference(ek.encoder_padded_operands(gru)[0], table,
                                                   tokens)
    want, want_ys = ek.encoder_int8_layers_reference(gru, table, tokens)
    assert got.shape[-1] == padded
    assert torch.equal(kc.unpad_units(got_ys, hidden, padded), want_ys)
    assert torch.equal(kc.unpad_units(got, hidden, padded), want)


@pytest.mark.parametrize("hidden,padded", [(717, 768), (576, 576), (600, 640)])
def test_plain_k2_k4_on_zero_units_at_wide_widths(float64_plain, hidden, padded):
    """K2's plain version on ``decode_padded_operands`` at bf16's width: the
    narrow decoder's logits (within 1e-12 in float64) and samples (equal);
    K4's bit-equal in bf16 masters at the width they run."""
    args = _decode_case(np.random.default_rng(hidden), 5, hidden, 60, torch.float64, "cpu")
    ops = dk.decode_padded_operands(*args, padded=padded)
    assert ops[1].shape == (5, 4, padded)
    got, want = (dk.decode_sampling_reference(*a) for a in (ops, args))
    assert torch.equal(got[1], want[1])
    _close(got[:1], want[:1])
    args = _decode_case(np.random.default_rng(hidden + 1), 5, hidden, 60, BF16, "cpu",
                        big_row=2)
    ops = dk.decode_padded_operands(*args)
    assert ops[1].shape == (5, 4, padded)
    got, want = (dk.decode_sampling_int8_reference(*a) for a in (ops, args))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kernel", ["K1", "K3", "K2", "K4"])
def test_gate_major_padding_is_rejected_at_wide_widths(float64_plain, monkeypatch, kernel):
    """The planted fault at 577 -> 640 and 717 -> 768: the gate columns
    padded as a whole at the end move each plain version far past its
    bound (K3's and K4's off bit-equality), where the gate-by-gate layout
    is exact."""
    if kernel in ("K1", "K3"):
        dtype = torch.float64 if kernel == "K1" else BF16
        gru, table, tokens, _ = _encoder_case(577, dtype, batch=3)
        plain = ek.encoder_hn_reference if kernel == "K1" else ek.encoder_hn_int8_reference

        def run():
            padded = ek.encoder_padded_operands(gru, padded=640)[0]
            return plain(padded, table, tokens)[..., :577].float(), \
                plain(gru, table, tokens).float()
    else:
        dtype = torch.float64 if kernel == "K2" else BF16
        args = _decode_case(np.random.default_rng(7), 5, 717, 60, dtype, "cpu")
        plain = (dk.decode_sampling_reference if kernel == "K2"
                 else dk.decode_sampling_int8_reference)

        def run():
            return plain(*dk.decode_padded_operands(*args, padded=768))[0].float(), \
                plain(*args)[0].float()
    got, want = run()
    assert (got - want).abs().max().item() <= (EXACT if dtype == torch.float64 else 0.0)
    monkeypatch.setattr(kc, "gate_padding", lambda: 1)
    got, want = run()
    assert (got - want).abs().max().item() > 1e-2


# --------------------------------------------------------------------------- #
# The port's encoder and decode at H 576 against the JAX package's models
# --------------------------------------------------------------------------- #
def test_wide_encoder_and_decode_match_jax_on_cpu():
    """bf16 masters at H 576, a few rows: the port's ``Encoder.apply`` (K1's
    route, its plain version on the CPU) against the JAX package's (its XLA
    scan on the CPU), h_n within test_torch_encoder_kernel's bf16 bound
    (8e-3: two ulps of |h| < 1). The port's decode (K2's route) from the
    same tick inputs against the JAX decoder's scan, tokens equal, and
    against its kernel (interpret mode, as the JAX package's own tests run
    it), tokens equal and logits within chip_smoke.py's bf16 bound (3e-2:
    two ulps of logits up to 4) where both fed back the same tokens: in
    bf16 the JAX scan's logits are 7.8e-2 from its own kernel's here (its
    products are rounded to bf16), the port's plain version 1.6e-2."""
    import jax
    import jax.numpy as jnp

    from inpaintnet_tpu.models.measure_vae import Encoder as JaxEncoder
    from inpaintnet_tpu.ops.decode_pallas import decode_sampling_pallas
    from inpaintnet_tpu.ops.gru import gru_apply as jax_gru_apply
    from inpaintnet_tpu_torch.models import measure_vae as mv
    from test_torch_decode_kernel import _setup

    def port(tree):
        return jax.tree_util.tree_map(
            lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16), tree)

    hidden, batch = 576, 3
    jenc = JaxEncoder(note_embedding_dim=8, rnn_hidden_size=hidden, num_layers=2, num_notes=30,
                      dropout=0.0, bidirectional=True, z_dim=12)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape), jnp.bfloat16),
        jenc.init_params(jax.random.PRNGKey(5)))
    tokens = rng.integers(0, 30, (batch, 24)).astype(np.int32)
    _, hn_j = jax_gru_apply(params["gru"], jnp.take(params["embedding"]["table"], tokens, axis=0),
                            last_outputs=False)  # what JaxEncoder.apply runs on the CPU
    dist_j = jenc.apply(params, jnp.asarray(tokens))
    enc = mv.Encoder(8, hidden, 2, 30, 12, device="meta")
    seen = []
    real = mv.encoder_hn
    try:
        mv.encoder_hn = lambda *a: seen.append(real(*a)) or seen[-1]
        dist = enc.apply(port(params), torch.from_numpy(tokens))
    finally:
        mv.encoder_hn = real
    assert len(seen) == 1 and seen[0].dtype == BF16
    np.testing.assert_allclose(seen[0].float().numpy(), np.asarray(hn_j.astype(jnp.float32)),
                               rtol=0, atol=8e-3)
    assert np.isfinite(dist.loc.float().numpy()).all() and dist.loc.shape == dist_j.loc.shape

    dec, params, tick_ctx, h_inits = _setup(batch, vocab=30, hidden=hidden, z_dim=12, seed=5)
    params, tick_ctx, h_inits = (jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), t)
                                 for t in (params, tick_ctx, h_inits))
    got = dk.decode_sampling(*map(port, (params, tick_ctx, h_inits)))
    _, s_scan = dec._decode_scan(params, tick_ctx, h_inits, train=False,
                                 rng=jax.random.PRNGKey(0), score_tensor=None)
    lg_k, s_k = decode_sampling_pallas(params, tick_ctx, h_inits, tile_b=8, interpret=True)
    assert np.array_equal(got[1].numpy(), np.asarray(s_scan))
    agree = dk.agreement(got, (port(lg_k).float(), torch.from_numpy(np.array(s_k)).int()))
    assert agree["tokens"] == 1.0 and agree["logits"] <= 3e-2, agree


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [576, 577])
def test_k1_k3_wide_on_card(cuda, hidden):
    """K1 bf16 (inference, and the training mode at rate 0.3) at H 576 (two
    consumer warpgroups at 576) and 577 (at 640, on zero units), 150 rows in
    chunks of 64 with a ragged last tile: within the bf16 bound of the plain
    version (weights' noise 0.8 / sqrt(H), as
    test_encoder_kernels_chunked_ragged_rows); one launch each. K3 on bf16
    masters refuses both (the JAX package does not quantize above 527) and
    runs 527 at 576, on zero units, bit-equal to its plain version."""
    gru, table, tokens = _encoder_int8_case(np.random.default_rng(hidden), 150, hidden, BF16,
                                            cuda, noise=0.8 / hidden ** 0.5)
    keep = torch.from_numpy(np.random.default_rng(1).random((150, 24, 2 * hidden)) >= 0.3).to(cuda)
    before = (ek.encoder_hn.launches, ek.encoder_hn_int8.launches)
    h_k = ek.encoder_hn(gru, table, tokens, max_chunk_rows=64)
    h_t = ek.encoder_hn(gru, table, tokens, max_chunk_rows=64, keep=keep, rate=0.3)
    with pytest.raises(ValueError, match="hidden size"):
        ek.encoder_hn_int8(gru, table, tokens)
    q_args = _encoder_int8_case(np.random.default_rng(hidden), 150, 527, BF16, cuda,
                                noise=0.8 / 527 ** 0.5)
    q_k = ek.encoder_hn_int8(*q_args)
    h_p = ek.encoder_hn_reference(gru, table, tokens)
    h_tp = ek.encoder_hn_reference(gru, table, tokens, keep, 0.3)
    q_p = ek.encoder_hn_int8_reference(*q_args)
    torch.cuda.synchronize()
    assert (ek.encoder_hn.launches, ek.encoder_hn_int8.launches) == (before[0] + 2,
                                                                     before[1] + 1)
    assert h_k.shape == (4, 150, hidden) and q_k.shape == (4, 150, 527)
    torch.testing.assert_close(h_k.float(), h_p.float(), rtol=0, atol=ATOL[BF16])
    torch.testing.assert_close(h_t.float(), h_tp.float(), rtol=0, atol=ATOL[BF16])
    assert torch.equal(q_k, q_p)


WIDE_DECODES = [(h, v) for h in (576, 640, 704, 717, 768) for v in (60, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,vocab", WIDE_DECODES)
def test_k2_wide_every_cluster_size(cuda, monkeypatch, hidden, vocab):
    """K2 bf16 at every cluster size of the width it runs H at (576: 3;
    640: 2; 768: 2 and 4, half-slab boxes), 70 rows: bit-equal across sizes
    (a cluster only moves h) and within the plain version's bounds, as
    test_decode_kernel_bf16_every_cluster_size holds H 512."""
    rng = np.random.default_rng(hidden + vocab)
    params, tick_ctx, h_inits = _decode_case(rng, 70, hidden, vocab, BF16, cuda)
    width = kc.decode_width(hidden, BF16)
    outs = {}
    for cluster in kc.decode_cluster_sizes(width):
        with monkeypatch.context() as m:
            real = dk.launch_plan
            m.setattr(dk, "launch_plan", lambda *s, c=cluster: real(*s)._replace(cluster=c))
            before = dk.decode_sampling.launches
            outs[cluster] = dk.decode_sampling(params, tick_ctx, h_inits)
            assert dk.decode_sampling.launches == before + 1
    lg_p, s_p = dk.decode_sampling_reference(params, tick_ctx, h_inits)
    torch.cuda.synchronize()
    lg_k, s_k = next(iter(outs.values()))
    assert all(_bit_equal(o, (lg_k, s_k)) for o in outs.values())
    assert (s_k == s_p).float().mean().item() >= 0.99
    same_rows = (s_k == s_p).all(dim=1)
    got, want = lg_k[same_rows].float(), lg_p[same_rows].float()
    assert ((got - want).abs() <= _two_ulps(want)).all()


def _two_ulps(want: torch.Tensor) -> torch.Tensor:
    """test_decode_kernel_bf16_every_cluster_size's logit bound, ATOL x 4
    (two bf16 ulps of logits up to 4), carried to larger logits as two ulps
    of each value: the wider heads' logits reach 8 and more on these
    weights (a summation-order flip of one rounding there is 0.0625)."""
    ulps = 2 * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1.0))) - 7)
    return ulps.clamp_min(ATOL[BF16] * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,vocab", WIDE_DECODES)
def test_k4_wide_every_cluster_size(cuda, monkeypatch, hidden, vocab):
    """K4 on bf16 masters at every cluster size of its width, 70 rows with
    a row whose init hiddens reach far above 1: bit-equal to the plain
    version."""
    rng = np.random.default_rng(hidden + vocab + 1)
    params, tick_ctx, h_inits = _decode_case(rng, 70, hidden, vocab, BF16, cuda, big_row=23)
    want = dk.decode_sampling_int8_reference(params, tick_ctx, h_inits)
    for cluster in kc.decode_cluster_sizes(kc.decode_width(hidden, BF16)):
        with monkeypatch.context() as m:
            real = dk.int8_plan
            m.setattr(dk, "int8_plan", lambda *s, c=cluster: real(*s)._replace(cluster=c))
            before = dk.decode_sampling_int8.launches
            got = dk.decode_sampling_int8(params, tick_ctx, h_inits)
            assert dk.decode_sampling_int8.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), cluster


def _wide_model(enc_hidden: int, dec_hidden: int, device, vocab: int = 30, seed: int = 0):
    """A LatentRNN (2 x 64) over a MeasureVAE whose encoder is
    ``enc_hidden`` and whose decoder is ``dec_hidden`` units wide, seeded
    random weights (``presets.build_flagship``'s construction, two widths)."""
    from inpaintnet_tpu_torch.models.convert import from_jax_params
    from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset

    vae = MeasureVAE(VocabOnlyDataset(vocab), note_embedding_dim=6, num_encoder_layers=2,
                     encoder_hidden_size=enc_hidden, latent_space_dim=8, num_decoder_layers=2,
                     decoder_hidden_size=dec_hidden, device="meta")
    model = LatentRNN(vae, num_rnn_layers=2, rnn_hidden_size=64, device="meta")
    rng = np.random.default_rng(seed)
    vae_np = vae.init_params(rng)
    model.to_empty(device=device)
    model.load_state_dict(from_jax_params(vae_np, model.init_params(rng)), strict=True)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wide_engine_graph_route_equals_eager_route(cuda, dtype):
    """An engine over a VAE whose encoder is 577 wide (K1 at 640, on zero
    units) and whose decoder is 640 wide (K2 / K4 on 2 CTAs a tile,
    one-slab boxes): its graph route's tokens and launches equal its eager
    route's, each of the two kernels launched. In int8 the encoder runs K1,
    as the JAX package's encoder gate (527 in bf16) serves it unquantized."""
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    model = _wide_model(577, 640, cuda)
    engine = InpaintingEngine(model, batch_buckets=(1, 4), dtype=dtype, n_bars=8, device=cuda)
    kernels = ([ek.encoder_hn, dk.decode_sampling_int8] if dtype == "int8"
               else [ek.encoder_hn, dk.decode_sampling])
    tokens = np.random.default_rng(0).integers(0, 30, (3, 8, 24)).astype(np.int32)
    _both_routes(engine, [lambda e: e.inpaint(tokens, 3, 2, seed=7),
                          lambda e: e.inpaint_variations(tokens, 3, 2, 2, seed=3)], kernels)
