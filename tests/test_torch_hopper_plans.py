"""The Python side of the Hopper routes of K8 and K2 (``csrc/gru_layer_hopper.cuh``,
``csrc/decode_hopper.cuh``), K6 (``csrc/gru_bwd_hopper.cuh``) and K7
(``csrc/arnn_hopper.cuh``), which the CPU can check: the launch plans at
the engines' and the trainer's row counts and the CTAs they launch, the
packed weight layouts against the unpacked weights, K6's split of f32
values into bf16 pieces, and the per-weight operand caches."""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import arnn_kernel as ak
from inpaintnet_tpu_torch.ops import decode_kernel as dk
from inpaintnet_tpu_torch.ops import encoder_kernel as ek
from inpaintnet_tpu_torch.ops import gru_kernel as gk
from inpaintnet_tpu_torch.ops import gru_train_kernel as tk
from inpaintnet_tpu_torch.ops import kernel_common as kc

SMS = 132  # an H100 SXM


def _assert_covers_once(rows: int, hidden: int, plan) -> None:
    """The CTAs of ``plan`` cover every (row, unit) exactly once: the row
    tiles partition the rows, and within each the clusters' unit ranges
    partition the units in whole 64-unit blocks of at most 512."""
    blocks = kc.plan_blocks(rows, hidden, plan)
    assert len(blocks) == -(-rows // 64) * plan.cluster
    by_tile = {}
    for r0, r1, u0, u1 in blocks:
        assert 0 <= r0 < r1 <= rows and r1 - r0 <= 64
        assert 0 <= u0 < u1 <= hidden and u0 % 64 == 0 and u1 - u0 <= 512
        by_tile.setdefault((r0, r1), []).append((u0, u1))
    edges = sorted(by_tile)
    assert edges[0][0] == 0 and edges[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    for units in by_tile.values():
        units.sort()
        assert units[0][0] == 0 and units[-1][1] == hidden
        assert all(a[1] == b[0] for a, b in zip(units, units[1:]))


# (rows, hidden, cluster, stages): the context GRUs and the beat GRU (H 512),
# the generation GRU and its autoregressive step (H 1024), at batch 1 and
# 2048 (decode rows 6 and 12,288), and the encoder-scale 65,536 rows
@pytest.mark.parametrize("rows,hidden,cluster,stages", [
    (1, 512, 8, 3), (2048, 512, 4, 3), (12288, 512, 2, 3), (65536, 512, 1, 3),
    (1, 1024, 8, 2), (6, 1024, 8, 2), (2048, 1024, 4, 2), (12288, 1024, 2, 2),
    (65536, 1024, 2, 2), (37, 64, 1, 6)])
def test_gru_layer_launch_plan(rows, hidden, cluster, stages):
    plan = gk.launch_plan(rows, hidden, SMS)
    assert plan == kc.LaunchPlan(cluster, stages)
    _assert_covers_once(rows, hidden, plan)


@pytest.mark.parametrize("rows,hidden,cluster,stages", [
    (6, 512, 8, 2), (2048, 512, 4, 2), (12288, 512, 2, 2), (65536, 512, 1, 2),
    (45, 128, 2, 4), (6, 64, 1, 6)])
def test_decode_launch_plan(rows, hidden, cluster, stages):
    plan = dk.launch_plan(rows, hidden, SMS)
    assert plan == kc.LaunchPlan(cluster, stages)
    _assert_covers_once(rows, hidden, plan)


H100_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15}  # clusters an H100 runs at once (cudaOccupancy...)


@pytest.mark.parametrize("module,rows,hidden,cluster", [
    (gk, 2048, 512, 8), (gk, 12288, 512, 2), (gk, 2048, 1024, 8), (gk, 1, 1024, 8),
    (dk, 2048, 512, 8), (dk, 12288, 512, 2), (dk, 6, 512, 8)])
def test_launch_plans_with_an_h100s_cluster_slots(module, rows, hidden, cluster):
    """An H100 holds 30 clusters of 4 and 15 of 8, not 33 and 16: 32 tiles
    at 4 would take two waves, so 2,048 rows take 8 (three waves of an
    eighth of a tile's units beat two of a quarter)."""
    slots = {c: n for c, n in H100_SLOTS.items() if c in kc.cluster_sizes(hidden)}
    plan = module.launch_plan(rows, hidden, SMS, slots)
    assert plan.cluster == cluster
    _assert_covers_once(rows, hidden, plan)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [1, 130, 2100])
def test_every_cluster_size_covers_once(rows, cluster):
    _assert_covers_once(rows, 1024 if cluster > 1 else 512, kc.LaunchPlan(cluster, 2))


def test_plans_fit_shared_memory_and_reject_unsplittable_widths():
    """Each plan's h tiles and rings fit the 227 KB opt-in (the C++ side's
    ``smem_bytes``); above 512 units an odd number of 64-unit blocks has no
    cluster split, so the bf16 route's plan rejects it and the wrapper runs
    it one block wider, on zero units, while the f32 route takes it."""
    for hidden, tiles in ((512, 1), (1024, 1), (512, 2), (64, 2), (192, 1)):
        stages = kc.ring_stages(hidden, tiles)
        used = tiles * 64 * hidden * 2 + 2 * stages * kc.box_slabs(hidden) * 96 * 128 + 1024
        assert 2 <= stages <= 6 and used <= kc.HOPPER_SMEM_BUDGET
    assert [kc.box_slabs(h) for h in (64, 128, 192, 512, 1024)] == [1, 2, 1, 2, 2]
    assert kc.cluster_sizes(1024) == [2, 4, 8] and kc.cluster_sizes(576) == []
    with pytest.raises(ValueError, match="hidden size 576"):
        gk.launch_plan(64, 576, SMS)
    assert kc.gru_layer_width(576, torch.bfloat16) == 640
    assert kc.gru_layer_width(576, torch.float32) == 576
    assert kc.gru_layer_supports_hidden(1024, torch.bfloat16)


def _gate_columns(w, hidden, c, g):
    """W's columns of gate g for the 32 units of chunk c, as rows (W^T)."""
    return w[:, g * hidden + 32 * c: g * hidden + 32 * c + 32].t()


@pytest.mark.parametrize("hidden", [64, 192, 512])
def test_pack_gate_blocks_layout(hidden):
    """Block [c, k] of the packed W^T is the (96, 64) k-slab k of chunk c:
    row 32g + u, column kk is gate g's column of unit 32c + u at input
    64k + kk, so one TMA box of consecutive blocks is one chunk's k-slabs."""
    w = torch.arange(hidden * 3 * hidden, dtype=torch.float32).reshape(hidden, 3 * hidden)
    packed = ek.pack_gate_blocks(w)
    assert packed.shape == (hidden // 32, hidden // 64, 96, 64) and packed.is_contiguous()
    for c in range(hidden // 32):
        for k in range(hidden // 64):
            for g in range(3):
                torch.testing.assert_close(packed[c, k, 32 * g: 32 * g + 32],
                                           _gate_columns(w, hidden, c, g)[:, 64 * k: 64 * k + 64],
                                           rtol=0, atol=0)


def test_pack_decode_weights_layout():
    """W_hh0, W_ih1, W_hh1 as ``pack_gate_blocks`` lays them out, one after
    the other, then the head's W^T as one more chunk: rows 0..V-1 of each of
    its k-slabs the head's columns, then zeros up to 96."""
    hidden, vocab = 128, 13
    rng = np.random.default_rng(0)
    ws = [torch.from_numpy(rng.standard_normal((hidden, 3 * hidden)).astype(np.float32))
          for _ in range(3)]
    head = torch.from_numpy(rng.standard_normal((hidden, vocab)).astype(np.float32))
    packed = dk.pack_decode_weights(*ws, head)
    chunks = hidden // 32
    assert packed.shape == (3 * chunks + 1, hidden // 64, 96, 64) and packed.is_contiguous()
    for i, w in enumerate(ws):
        torch.testing.assert_close(packed[chunks * i: chunks * (i + 1)], ek.pack_gate_blocks(w),
                                   rtol=0, atol=0)
    for k in range(hidden // 64):
        torch.testing.assert_close(packed[-1, k, :vocab], head.t()[:, 64 * k: 64 * k + 64],
                                   rtol=0, atol=0)
    assert not packed[-1, :, vocab:].any()


def test_layer_operands_follow_in_place_updates(monkeypatch):
    """K8's packed W_hh^T is built once per weight tensor and rebuilt after
    an in-place update (its ``_version`` moves) or for another tensor."""
    maps = []
    monkeypatch.setattr(gk, "slab_map", lambda packed: (maps.append(packed) or None, 64))
    monkeypatch.setattr(gk, "layer_operands", kc.WeightCache(gk._build_layer_operands))
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 192)).astype(np.float32)).bfloat16()
    first = gk.layer_operands(w)[0]
    assert gk.layer_operands(w)[0] is first and len(maps) == 1
    with torch.no_grad():
        w.mul_(2)
    second = gk.layer_operands(w)[0]
    assert len(maps) == 2 and second is not first
    torch.testing.assert_close(second, 2 * first, rtol=0, atol=0)
    torch.testing.assert_close(second, ek.pack_gate_blocks(w), rtol=0, atol=0)
    other = w.clone()
    assert gk.layer_operands(other)[0] is not second and len(maps) == 3


def test_decode_operands_follow_in_place_updates(monkeypatch):
    """K2's packed weights and stacked biases are built once per set of
    weight tensors; an in-place update of any of them rebuilds them, in
    both routes' layouts."""
    monkeypatch.setattr(dk, "slab_map", lambda packed: (None, 64))
    monkeypatch.setattr(dk, "f32_map", lambda packed: (None, 64))
    monkeypatch.setattr(dk, "decode_operands", kc.WeightCache(dk._build_decode_operands))
    rng = np.random.default_rng(2)
    for dtype in (torch.bfloat16, torch.float32):
        ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
              for s in ((64, 192), (64, 192), (64, 192), (64, 13), (192,), (192,), (192,),
                        (13,))]
        ops = dk.decode_operands(*ws)
        assert dk.decode_operands(*ws) is ops
        with torch.no_grad():
            ws[5].add_(1)
        fresh = dk.decode_operands(*ws)
        assert fresh is not ops
        torch.testing.assert_close(fresh["bias"][1], ws[5], rtol=0, atol=0)
        assert fresh["head_b"].shape == (96,)


def test_weight_cache_counts_no_versions_of_inference_tensors():
    calls = []
    cache = kc.WeightCache(lambda w: calls.append(w) or len(calls))
    with torch.inference_mode():
        w = torch.ones(4)
    assert cache(w) == 1 and cache(w) == 2  # rebuilt: an update could not be seen
    v = torch.ones(4)
    assert cache(v) == 3 and cache(v) == 3


# --------------------------------------------------------------------------- #
# K6 (csrc/gru_bwd_hopper.cuh): the split product's pieces, the packed W
# pieces, the launch plan and the operand cache
# --------------------------------------------------------------------------- #


def test_split_bf16_pieces_sum_back():
    """bf16 inputs are their own hi piece (mid = lo = 0); f32 inputs come
    back from hi + mid + lo to within 2^-24 of their magnitude."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 4, 4096))
                         .astype(np.float32))
    xb = x.to(torch.bfloat16)
    hi, mid, lo = tk.split_bf16_pieces(xb)
    assert all(p.dtype == torch.bfloat16 for p in (hi, mid, lo))
    assert torch.equal(hi, xb) and not mid.any() and not lo.any()
    hi, mid, lo = tk.split_bf16_pieces(x)
    back = hi.double() + mid.double() + lo.double()
    assert ((back - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    assert ((hi.double() - x.double()).abs() > 2.0 ** -20 * x.double().abs()).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_product_passes_hold_f32(dtype):
    """K6's passes over the pieces (bf16: dhw's three against W; f32: the
    six cross terms down to 2^-24) give dhw @ W^T, with dhw taken in f32 and
    W in its dtype, to within a few 2^-24 of the sum of |terms|: the
    product keeps f32's precision (the planted fault, dhw rounded to bf16,
    is 2^-9 off)."""
    rng = np.random.default_rng(5)
    dhw = torch.from_numpy(rng.standard_normal((16, 192)).astype(np.float32))
    w = torch.from_numpy((0.2 * rng.standard_normal((64, 192))).astype(np.float32)).to(dtype)
    a = tk.split_bf16_pieces(dhw)
    b = tk.split_bf16_pieces(w) if dtype == torch.float32 else (w, None, None)
    pairs = ([(2, 0), (1, 0), (0, 0)] if dtype == torch.bfloat16
             else [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)])
    got = sum(a[i].double() @ b[j].double().t() for i, j in pairs)
    exact = dhw.double() @ w.double().t()
    scale = dhw.double().abs() @ w.double().abs().t()
    assert ((got - exact).abs() <= 4 * 2.0 ** -24 * scale).all()
    rounded = dhw.to(torch.bfloat16).double() @ w.double().t()
    assert ((rounded - exact).abs() > 64 * 2.0 ** -24 * scale).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 192])
def test_pack_bwd_weights_layout(dtype, hidden):
    """Element [k, p, j, kk] of the packed W is piece p of W_hh[j, 64 k + kk]:
    a CTA's units are contiguous rows of each k-slab's piece."""
    rng = np.random.default_rng(hidden)
    w = torch.from_numpy(rng.standard_normal((hidden, 3 * hidden)).astype(np.float32)).to(dtype)
    packed = tk.pack_bwd_weights(w)
    pieces = [w] if dtype == torch.bfloat16 else list(tk.split_bf16_pieces(w))
    assert packed.shape == (3 * hidden // 64, len(pieces), hidden, 64) and packed.is_contiguous()
    assert packed.dtype == torch.bfloat16
    for k in range(3 * hidden // 64):
        for p, piece in enumerate(pieces):
            torch.testing.assert_close(packed[k, p], piece[:, 64 * k: 64 * k + 64], rtol=0,
                                       atol=0)


def test_bwd_cluster_sizes_take_every_kernel_width():
    """Every width K6 takes (multiples of 64 up to 512) has a cluster size
    in each dtype, at most 128 units a CTA."""
    for hidden in range(64, 513, 64):
        for dtype in (torch.float32, torch.bfloat16):
            sizes = tk.bwd_cluster_sizes(hidden, dtype)
            assert sizes, (hidden, dtype)
            for c in sizes:
                units = hidden // c
                assert (hidden // 64) % c == 0 and units <= 128
                stages = tk.bwd_ring_stages(units, tk.bwd_weight_pieces(dtype))
                stage = 3 * 64 * 128 + tk.bwd_weight_pieces(dtype) * units * 128
                used = stages * stage + 64 * (units + 8) * 4 + 1024
                assert 2 <= stages <= 6 and used <= kc.HOPPER_SMEM_BUDGET
    assert tk.bwd_cluster_sizes(512, torch.float32) == [4, 8]
    assert tk.bwd_cluster_sizes(512, torch.bfloat16) == [4, 8]
    assert tk.bwd_cluster_sizes(384, torch.float32) == [3, 6]
    assert tk.bwd_cluster_sizes(320, torch.bfloat16) == [5]
    assert tk.bwd_cluster_sizes(48, torch.bfloat16) == []
    with pytest.raises(ValueError, match="hidden size 48"):
        tk.bwd_plan(48, torch.float32)


# (rows, hidden, dtype, cluster, stages): the VAE encoder's 4,096 rows, the
# tick GRU's 16,384, a one-tile call, small widths
@pytest.mark.parametrize("rows,hidden,dtype,cluster,stages", [
    (4096, 512, torch.bfloat16, 8, 6), (16384, 512, torch.bfloat16, 8, 6),
    (4096, 512, torch.float32, 8, 4), (16384, 512, torch.float32, 8, 4),
    (37, 512, torch.float32, 8, 4), (4096, 64, torch.float32, 1, 4),
    (4096, 128, torch.bfloat16, 2, 6), (300, 384, torch.bfloat16, 6, 6),
    (300, 448, torch.float32, 7, 4)])
def test_bwd_plan(rows, hidden, dtype, cluster, stages):
    """The plan's C: the largest size, at most 128 units a CTA (the
    shortest chain a step; PERF.md has the times at other sizes)."""
    plan = tk.bwd_plan(hidden, dtype)
    assert plan == kc.LaunchPlan(cluster, stages)
    _assert_covers_once(rows, hidden, plan)


def test_bwd_operands_follow_in_place_updates(monkeypatch):
    """K6's packed W pieces are built once per weight tensor and rebuilt
    after an Adam step's in-place update."""
    monkeypatch.setattr(tk, "bwd_operands", kc.WeightCache(tk._build_bwd_operands))
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((64, 192)).astype(np.float32))
    first = tk.bwd_operands(w)
    assert tk.bwd_operands(w) is first
    with torch.no_grad():
        w.sub_(0.5)
    second = tk.bwd_operands(w)
    assert second is not first and second["maps"] == {}
    torch.testing.assert_close(second["packed"], tk.pack_bwd_weights(w), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# K7's bf16 route (csrc/arnn_hopper.cuh)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,hidden,linear,cluster,stages", [
    (512, 256, 256, 4, 3), (64, 256, 256, 4, 3), (1, 256, 256, 4, 3),
    (4096, 256, 256, 2, 3), (37, 128, 64, 2, 5), (5, 64, 12, 1, 5)])
def test_arnn_plan(rows, hidden, linear, cluster, stages):
    """The flagship's batches (512, 64, 1 rows: 8 tiles or one) fit one wave
    of clusters of 4 on an H100; 64 tiles take 2."""
    sizes = ak.arnn_cluster_sizes(hidden, ak.arnn_head_width(linear))
    slots = {c: n for c, n in H100_SLOTS.items() if c in sizes}
    plan = ak.arnn_plan(rows, hidden, linear, SMS, slots)
    assert plan == kc.LaunchPlan(cluster, stages)
    _assert_covers_once(rows, hidden, plan)


def test_arnn_smem_and_gate():
    """Each plan's tiles (the hidden tile of ``arnn_hid_cols`` columns, a
    whole number of rounds of the padded head), c carries and rings fit the
    227 KB opt-in; the Hopper route takes every width at any head width and
    vocabulary: H 512 at a 256-wide head with a 128-column hidden tile in
    two rounds, a 1,024-wide head in rounds, H 320 and 448 on clusters of 5
    and 7; two CUDA launches a chunk everywhere, none of the first kernel."""
    for hidden, linear in ((256, 256), (64, 12), (128, 64), (256, 512), (512, 256),
                           (256, 1024), (320, 256), (448, 512)):
        lp = ak.arnn_head_width(linear)
        assert ak.arnn_cluster_sizes(hidden, lp)
        for c in ak.arnn_cluster_sizes(hidden, lp):
            ht = ak.arnn_hid_cols(hidden, c, lp)
            stages = ak.arnn_ring_stages(hidden, c, ht)
            assert lp % ht == 0 and 2 <= stages and ak.arnn_smem_bytes(hidden, c, ht, stages) <= \
                kc.HOPPER_SMEM_BUDGET
    assert ak.arnn_cluster_sizes(256, 256) == [1, 2, 4] and ak.arnn_hid_cols(256, 4, 256) == 256
    assert ak.arnn_cluster_sizes(512, 256) == [8] and ak.arnn_hid_cols(512, 8, 256) == 128
    assert ak.arnn_hid_cols(256, 4, 1024) == 512
    assert ak.arnn_cluster_sizes(320, 256) == [5] and ak.arnn_cluster_sizes(448, 256) == [7]
    assert ak.arnn_hopper_supports(256, 256, 60)
    assert ak.arnn_hopper_supports(256, 256, 65) and ak.arnn_hopper_supports(256, 256, 1280)
    assert ak.arnn_hopper_supports(512, 256, 60) and ak.arnn_hopper_supports(256, 1024, 90)
    assert ak.arnn_kernel_supports(256, 256, 256, 60, torch.bfloat16)
    assert ak.arnn_kernel_supports(256, 256, 256, 65, torch.bfloat16)
    assert ak.arnn_kernel_supports(512, 512, 256, 60, torch.bfloat16)
    assert ak.arnn_kernel_supports(256, 256, 256, 65, torch.float32)
    assert ak.arnn_cluster_sizes(96, 256) == []  # 96 runs at 128, on zero units
    assert ak.arnn_kernel_supports(96, 256, 256, 60, torch.bfloat16)
    assert ak.arnn_cuda_launches(torch.bfloat16, 512, 384, 256, 256, 60) == 2
    assert ak.arnn_cuda_launches(torch.bfloat16, 512, 384, 512, 256, 60) == 2
    assert ak.arnn_cuda_launches(torch.bfloat16, 512, 384, 256, 1024, 256) == 2
    # f32: the split route's two a chunk, at a vocabulary over 64 too
    assert ak.arnn_cuda_launches(torch.float32, 512, 384, 256, 256, 60) == 2
    assert ak.arnn_cuda_launches(torch.float32, 512, 384, 256, 256, 65) == 2
    with pytest.raises(ValueError, match="hidden size 96"):
        ak.arnn_plan(64, 96, 256, SMS)


def _lstm_columns(w, hidden, c, gate):
    """W's columns of gate ``gate`` for the 32 units of chunk c, as rows."""
    return w[:, gate * hidden + 32 * c: gate * hidden + 32 * c + 32].t()


@pytest.mark.parametrize("k_dim,hidden", [(64, 64), (128, 64), (64, 128)])
def test_pack_lstm_blocks_layout(k_dim, hidden):
    """Block [c, k] is the (128, 64) k-slab k of 4-gate chunk c: row
    32 g + u, column kk is gate g's column of unit 32 c + u at input 64 k + kk."""
    w = torch.arange(k_dim * 4 * hidden, dtype=torch.float32).reshape(k_dim, 4 * hidden)
    packed = ak.pack_lstm_blocks(w)
    assert packed.shape == (hidden // 32, k_dim // 64, 128, 64) and packed.is_contiguous()
    for c in range(hidden // 32):
        for k in range(k_dim // 64):
            for g in range(4):
                torch.testing.assert_close(packed[c, k, 32 * g: 32 * g + 32],
                                           _lstm_columns(w, hidden, c, g)[:, 64 * k: 64 * k + 64],
                                           rtol=0, atol=0)


@pytest.mark.parametrize("hidden,linear,vocab,kslabs", [(128, 200, 70, 4), (384, 256, 70, 2)])
def test_pack_arnn_weights_layout(hidden, linear, vocab, kslabs):
    """W_hh0's chunks; layer 1's chunks, W_ih1's k-slabs then W_hh1's; the
    head's W_l1^T in 128-column chunks (zero past L); W_out^T by chunks of
    64 columns (zero past V and L): with 4 k-slabs a block each chunk's
    halves of 32 columns, the head padded to 256; with 2 (H 384 at a
    256-wide head: a 128-column hidden tile in rounds) the chunk's 64."""
    rng = np.random.default_rng(7)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w_hh0, w_ih1, w_hh1 = (rand(hidden, 4 * hidden) for _ in range(3))
    w_l1, w_out = rand(hidden, linear), rand(linear, vocab)
    packed = ak.pack_arnn_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out)
    nc, kb, lp = hidden // 32, hidden // 64, ak.arnn_head_width(linear)
    assert ak.arnn_out_kslabs(hidden, lp) == kslabs
    chunks, width = ak.arnn_out_chunks(vocab), -(-lp // (64 * kslabs)) * 64 * kslabs
    rows = 128 // kslabs
    nb = width // (64 * kslabs)  # blocks of a chunk's part
    assert chunks == 2
    assert packed.shape == (nc * kb + nc * 2 * kb + lp // 128 * kb + chunks * 64 // rows * nb,
                            128, 64)
    torch.testing.assert_close(packed[:nc * kb], ak.pack_lstm_blocks(w_hh0).reshape(-1, 128, 64),
                               rtol=0, atol=0)
    layer1 = packed[nc * kb: 3 * nc * kb].reshape(nc, 2 * kb, 128, 64)
    torch.testing.assert_close(layer1[:, :kb], ak.pack_lstm_blocks(w_ih1), rtol=0, atol=0)
    torch.testing.assert_close(layer1[:, kb:], ak.pack_lstm_blocks(w_hh1), rtol=0, atol=0)
    head = packed[3 * nc * kb: 3 * nc * kb + lp // 128 * kb].reshape(lp // 128, kb, 128, 64)
    for lc in range(lp // 128):
        for k in range(kb):
            want = torch.zeros(128, 64)
            cols = w_l1[64 * k: 64 * k + 64, 128 * lc: 128 * lc + 128].t()
            want[:cols.shape[0]] = cols
            torch.testing.assert_close(head[lc, k], want, rtol=0, atol=0)
    out = packed[-chunks * 64 // rows * nb:].reshape(chunks, 64 // rows, nb, kslabs, rows, 64)
    full = torch.zeros(64 * chunks, width)
    full[:vocab, :linear] = w_out.t()
    for c in range(chunks):
        for part in range(64 // rows):
            for b in range(nb):
                for kk in range(kslabs):
                    k, r0 = kslabs * b + kk, 64 * c + rows * part
                    torch.testing.assert_close(out[c, part, b, kk],
                                               full[r0: r0 + rows, 64 * k: 64 * k + 64],
                                               rtol=0, atol=0)


def test_arnn_operands_follow_in_place_updates(monkeypatch):
    """K7's token table, packed weights and padded biases are built once per
    set of weight tensors and rebuilt after an in-place update of any."""
    monkeypatch.setattr(ak, "arnn_map", lambda packed, halves: (None, 64))
    monkeypatch.setattr(ak, "arnn_operands", kc.WeightCache(ak._build_arnn_operands))
    rng = np.random.default_rng(8)
    hidden, ctx, emb, linear, vocab = 64, 64, 10, 12, 30
    shapes = ((vocab + 1, emb), (emb + ctx, 4 * hidden), (4 * hidden,), (hidden, 4 * hidden),
              (4 * hidden,), (hidden, 4 * hidden), (4 * hidden,), (hidden, 4 * hidden),
              (4 * hidden,), (hidden, linear), (linear,), (linear, vocab), (vocab,))
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16() for s in shapes]
    ops = ak.arnn_operands(*ws)
    assert ak.arnn_operands(*ws) is ops
    assert ops["b_l1"].shape == (128,) and ops["b_out"].shape == (64,)
    torch.testing.assert_close(ops["w_ctx_t"], ws[1][emb:].t(), rtol=0, atol=0)
    with torch.no_grad():
        ws[0].add_(1)  # the embedding table: the token table follows it
    fresh = ak.arnn_operands(*ws)
    assert fresh is not ops
    torch.testing.assert_close(fresh["tok_tab"],
                               (ws[0].float() @ ws[1][:emb].float()).bfloat16(), rtol=0, atol=0)


def test_arnn_chunk_rows(monkeypatch):
    """The flagship's batch 512 x 384 ticks is one chunk (805 MB of f32
    projection); chunks are whole 64-row tiles under the cap, at least one."""
    assert ak.arnn_chunk_rows(512, 384, 256) == 512
    assert ak.arnn_chunk_rows(4096, 384, 256) == 1664
    assert ak.arnn_chunk_rows(3, 24, 128) == 3
    monkeypatch.setattr(ek, "XW_SCRATCH_BYTES", 100 * 24 * 512 * 4)
    assert ak.arnn_chunk_rows(150, 24, 128) == 64
    monkeypatch.setattr(ek, "XW_SCRATCH_BYTES", 1)
    assert ak.arnn_chunk_rows(150, 24, 128) == 64


# --------------------------------------------------------------------------- #
# K4 (csrc/decode_hopper.cuh on s8 wgmma): the plan over int8 h tiles, the
# int8 slab packing, the cached weight part
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,hidden,cluster,stages", [
    (6, 512, 8, 4), (2048, 512, 8, 4), (12288, 512, 8, 4), (65536, 512, 8, 4),
    (45, 128, 2, 6), (7, 64, 1, 6), (40, 192, 1, 6), (9, 256, 4, 6)])
def test_decode_int8_plan(rows, hidden, cluster, stages):
    """K4 takes the largest cluster size whatever the rows; its four int8 h
    tiles (each layer's double-buffered) are K2's two tiles' bytes, and its
    boxes of two 6 KB int8 k-slabs half K2's, so its rings get 4 stages at
    H 512 against K2's 2. Above 512 units: 576's nine blocks on an odd
    cluster of 3, and 704's eleven on none (it runs at 768)."""
    plan = dk.int8_plan(hidden)
    assert plan == kc.LaunchPlan(cluster, stages)
    _assert_covers_once(rows, hidden, plan)
    assert dk.int8_plan(576) == kc.LaunchPlan(3, 6)
    with pytest.raises(ValueError, match="hidden size 704"):
        dk.int8_plan(704)


def test_int8_tiles_and_rings_fit_shared_memory():
    """Four int8 h tiles and the rings of 6 KB k-slabs, box_slabs of them a
    box, fit the 227 KB opt-in (``gru_layer_hopper.cuh smem_bytes`` with
    64-byte rows)."""
    for hidden in range(64, 513, 64):
        stages = kc.ring_stages(hidden, 4, 1)
        used = 4 * 64 * hidden + 2 * stages * kc.box_slabs(hidden) * 96 * 64 + 1024
        assert 2 <= stages <= 6 and used <= kc.HOPPER_SMEM_BUDGET
        assert stages >= kc.ring_stages(hidden, 2)


@pytest.mark.parametrize("hidden,vocab", [(128, 13), (64, 96)])
def test_pack_decode_weights_int8_layout(hidden, vocab):
    """The int8 slabs K4 streams: k-slab k of chunk c holds, in its 96 rows of
    64 bytes (64 of K, one 64-byte swizzle row), gate g's column of unit
    32 c + u at input 64 k + kk; the head's chunk its V columns, then zero
    rows."""
    rng = np.random.default_rng(hidden + vocab)
    ws = [torch.from_numpy(rng.integers(-127, 128, (hidden, 3 * hidden)).astype(np.int8))
          for _ in range(3)]
    head = torch.from_numpy(rng.integers(-127, 128, (hidden, vocab)).astype(np.int8))
    packed = dk.pack_decode_weights(*ws, head)
    chunks = hidden // 32
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (3 * chunks + 1, hidden // 64, 96, 64)
    for i, w in enumerate(ws):
        for c in range(chunks):
            for k in range(hidden // 64):
                for g in range(3):
                    want = w[64 * k: 64 * k + 64, g * hidden + 32 * c: g * hidden + 32 * c + 32]
                    assert torch.equal(packed[chunks * i + c, k, 32 * g: 32 * g + 32], want.t())
    for k in range(hidden // 64):
        assert torch.equal(packed[-1, k, :vocab], head[64 * k: 64 * k + 64].t())
    assert not packed[-1, :, vocab:].any()


def _decoder_params(rng, hidden, vocab, dtype, emb=10):
    def rand(*shape, scale=0.3):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)
    layer = lambda k: {"w_ih": rand(k, 3 * hidden), "w_hh": rand(hidden, 3 * hidden),  # noqa: E731
                       "b_ih": rand(3 * hidden), "b_hh": rand(3 * hidden)}
    return {"embedding": {"table": rand(vocab, emb)}, "x_0": rand(emb),
            "tick_gru": [[layer(emb + hidden)], [layer(hidden)]],
            "head": {"w": rand(hidden, vocab), "b": rand(vocab)}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_int8_weight_part_equals_operands(monkeypatch, dtype):
    """K4's cached weight part equals ``decode_int8_operands``' (which the
    plain version builds whole on every call), and the data part holds the
    per-call rest; the packed slabs are the quantized weights' and the head's
    scales and bias are zero-padded to the 96-column head."""
    monkeypatch.setattr(dk, "slab_map", lambda packed: (None, 64))
    monkeypatch.setattr(dk, "decode_int8_weights", kc.WeightCache(dk._build_decode_int8_weights))
    rng = np.random.default_rng(9)
    params = _decoder_params(rng, 64, 13, dtype)
    tick_ctx = torch.from_numpy(rng.standard_normal((5, 4, 64)).astype(np.float32)).to(dtype)
    h_inits = torch.from_numpy(3 * rng.standard_normal((2, 5, 4, 64)).astype(np.float32)).to(dtype)
    ops = dk.decode_int8_operands(params, tick_ctx, h_inits)
    w = dk.decode_int8_weights(*dk._int8_weight_tensors(params))
    data = dk.decode_int8_data(params, tick_ctx, h_inits)
    assert set(data) == {"q", "hi0", "hi1", "ctx_xw"}
    for key, value in ops.items():
        got = data[key] if key in data else w[key]
        assert got.dtype == value.dtype and torch.equal(got, value), key
    assert data["hi0"].is_contiguous() and data["hi0"].shape == (4, 5, 64)
    assert torch.equal(w["packed"], dk.pack_decode_weights(ops["whh0_q"], ops["wih1_q"],
                                                           ops["whh1_q"], ops["head_q"]))
    assert w["head_s_pad"].shape == (96,) and not w["head_s_pad"][13:].any()
    assert torch.equal(w["head_b_pad"][:13], ops["head_b"])


def test_decode_int8_weights_follow_in_place_updates(monkeypatch):
    """K4's weight part is built once per set of weight tensors and rebuilt
    after an in-place update of any of them (the token table follows the
    embedding)."""
    monkeypatch.setattr(dk, "slab_map", lambda packed: (None, 64))
    monkeypatch.setattr(dk, "decode_int8_weights", kc.WeightCache(dk._build_decode_int8_weights))
    params = _decoder_params(np.random.default_rng(10), 64, 13, torch.bfloat16)
    first = dk.decode_int8_weights(*dk._int8_weight_tensors(params))
    assert dk.decode_int8_weights(*dk._int8_weight_tensors(params)) is first
    with torch.no_grad():
        params["embedding"]["table"].mul_(2)
    second = dk.decode_int8_weights(*dk._int8_weight_tensors(params))
    assert second is not first
    assert not torch.equal(second["scales"][3], first["scales"][3])
    assert torch.equal(second["whh0_q"], first["whh0_q"])


# --------------------------------------------------------------------------- #
# K5 (csrc/gru_fwd_hopper.cuh): the plan, the gate-block packing of the W
# pieces, the split product, the operand cache
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hidden,dtype,sizes,cluster,stages", [
    (512, torch.float32, [8], 8, 2), (512, torch.bfloat16, [4, 8], 8, 5),
    (64, torch.float32, [1], 1, 2), (128, torch.bfloat16, [1, 2], 2, 5),
    (384, torch.bfloat16, [3, 6], 6, 5), (448, torch.float32, [7], 7, 2)])
def test_fwd_plan(hidden, dtype, sizes, cluster, stages):
    """K5's cluster sizes own 64 units a CTA in f32 (the sum and two k-slab
    partials of a 64 x 96 tile fill a warpgroup's registers) and 64 or 128 in
    bf16; the plan takes the largest size; the rings fit beside the carry
    and, in bf16, the output buffers."""
    assert tk.fwd_cluster_sizes(hidden, dtype) == sizes
    plan = tk.fwd_plan(hidden, dtype)
    assert plan == kc.LaunchPlan(cluster, stages)
    _assert_covers_once(4096, hidden, plan)
    for c in sizes:
        units, pieces = hidden // c, tk.bwd_weight_pieces(dtype)
        st = tk.fwd_ring_stages(units, pieces)
        used = st * (pieces * 64 * 128 + pieces * units // 32 * 96 * 128) + 64 * (units + 8) * 4
        used += 4 * 64 * (units // 2 + 8) * 2 if dtype == torch.bfloat16 else 0
        assert 2 <= st <= 6 and used + 1024 <= kc.HOPPER_SMEM_BUDGET


def test_fwd_cluster_sizes_take_every_kernel_width():
    for hidden in range(64, 513, 64):
        for dtype in (torch.float32, torch.bfloat16):
            assert tk.fwd_cluster_sizes(hidden, dtype), (hidden, dtype)
    assert tk.fwd_cluster_sizes(48, torch.float32) == []
    with pytest.raises(ValueError, match="hidden size 48"):
        tk.fwd_plan(48, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128])
def test_pack_fwd_weights_layout(dtype, hidden):
    """Element [p, c, k, 32 g + u, kk] of the packed W is piece p of
    W_hh[64 k + kk, g H + 32 c + u]: per piece K8's gate blocks, so a CTA's
    chunks of one k-slab are one 5-D TMA box."""
    rng = np.random.default_rng(hidden + 1)
    w = torch.from_numpy(rng.standard_normal((hidden, 3 * hidden)).astype(np.float32)).to(dtype)
    packed = tk.pack_fwd_weights(w)
    pieces = [w] if dtype == torch.bfloat16 else list(tk.split_bf16_pieces(w))
    assert packed.shape == (len(pieces), hidden // 32, hidden // 64, 96, 64)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    for p, piece in enumerate(pieces):
        for c in range(hidden // 32):
            for k in range(hidden // 64):
                for g in range(3):
                    want = piece[64 * k: 64 * k + 64, g * hidden + 32 * c: g * hidden + 32 * c + 32]
                    assert torch.equal(packed[p, c, k, 32 * g: 32 * g + 32], want.t())


def test_fwd_product_passes_hold_f32():
    """K5's six passes over the pieces of the f32 carry h and of W_hh (lh,
    hl, mm, mh, hm, hh) give h @ W, both in f32, to within a few 2^-24 of the
    sum of |terms|; the planted fault, h taken as one bf16 piece against W's
    three, is 2^-9 off."""
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.uniform(-1, 1, (16, 128)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.standard_normal((128, 384))).astype(np.float32))
    a, b = tk.split_bf16_pieces(h), tk.split_bf16_pieces(w)
    pairs = [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)]
    got = sum(a[i].double() @ b[j].double() for i, j in pairs)
    exact = h.double() @ w.double()
    scale = h.double().abs() @ w.double().abs()
    assert ((got - exact).abs() <= 4 * 2.0 ** -24 * scale).all()
    one_piece = sum(a[0].double() @ b[j].double() for j in range(3))
    assert ((one_piece - exact).abs() > 64 * 2.0 ** -24 * scale).any()
    torch.testing.assert_close(tk.fwd_product(h, w, torch.float32), h @ w, rtol=0, atol=0)


def test_fwd_operands_follow_in_place_updates(monkeypatch):
    """K5's packed W pieces are built once per weight tensor and rebuilt
    after an Adam step's in-place update."""
    monkeypatch.setattr(tk, "fwd_operands", kc.WeightCache(tk._build_fwd_operands))
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.standard_normal((64, 192)).astype(np.float32))
    first = tk.fwd_operands(w)
    assert tk.fwd_operands(w) is first
    with torch.no_grad():
        w.add_(0.25)
    second = tk.fwd_operands(w)
    assert second is not first and second["maps"] == {}
    torch.testing.assert_close(second["packed"], tk.pack_fwd_weights(w), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# K1's and K7's f32 routes: the split product (six bf16 passes a k-slab),
# K1's plan and packed pieces, K7's plan, packing and the geometries that
# keep the first kernel
# --------------------------------------------------------------------------- #
def _scale_bound(a, w, got, want, ulps):
    """|got - want| within ``ulps`` x 2^-24 of the product's |terms|."""
    scale = a.double().abs() @ w.double().abs()
    return ((got.double() - want.double()).abs() <= ulps * 2.0 ** -24 * scale).all()


@pytest.mark.parametrize("case", ["encoder_projection", "arnn_context"])
def test_split_product_holds_the_f32_projections(case):
    """The split GEMM's arithmetic in plain PyTorch (``kernel_common.
    split_product``: per 64-wide k-slab six passes into a partial, the
    partials added in f32) against the f32 plain versions it stands for, K1's
    ``input_projection_reference`` and K7's ``ctx_projection``: within 16 x
    2^-24 of the sum of |terms| (a few f32 roundings of the slabs' sums). The
    planted fault, the operand taken as its hi piece alone, is 2^-9 off and
    breaks that bound."""
    rng = np.random.default_rng(13)
    if case == "encoder_projection":
        hidden = 128
        a = torch.from_numpy(rng.uniform(-1, 1, (96, 2 * hidden)).astype(np.float32))
        w = torch.from_numpy((0.1 * rng.standard_normal((2, 2 * hidden, 3 * hidden)))
                             .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, 3 * hidden)).astype(np.float32))
        want = ek.input_projection_reference(a, w, b)
        got = torch.stack([kc.split_product(a, w[d]) + b[d] for d in range(2)])
        fault = torch.stack([kc.split_product(a, w[d], pieces=1) + b[d] for d in range(2)])
        exact = torch.stack([a.double() @ w[d].double() + b[d].double() for d in range(2)])
        ok = all(_scale_bound(a, w[d], got[d], want[d], 16) for d in range(2))
        bad = any(not _scale_bound(a, w[d], fault[d], exact[d], 64) for d in range(2))
    else:
        a = torch.from_numpy((0.5 * rng.standard_normal((4, 24, 128))).astype(np.float32))
        w = torch.from_numpy((0.1 * rng.standard_normal((128, 256))).astype(np.float32))
        want = ak.ctx_projection(a, w).reshape(-1, 256)
        flat = a.reshape(-1, 128)
        got, fault = kc.split_product(flat, w), kc.split_product(flat, w, pieces=1)
        ok = _scale_bound(flat, w, got, want, 16)
        bad = not _scale_bound(flat, w, fault, flat.double() @ w.double(), 64)
    assert ok and bad


@pytest.mark.parametrize("hidden", [64, 128, 512])
def test_encoder_f32_plan_owns_64_units_a_cta(hidden):
    """K1's f32 layers run K5's f32 plan: H / 64 CTAs a tile, 64 units each
    (what ``inpaint_encoder_rec_f32`` and its W map take), two ring stages."""
    plan = tk.fwd_plan(hidden, torch.float32)
    assert plan == kc.LaunchPlan(hidden // 64, 2) and hidden // plan.cluster == 64
    _assert_covers_once(4096, hidden, plan)


@pytest.mark.parametrize("hidden", [64, 192])
def test_encoder_f32_packed_pieces(hidden):
    """K1's f32 W_hh pieces are K5's packing of each direction, stacked
    direction-major; W_ih1^T's pieces (the split GEMM's B) are element [d, p,
    n, k] = piece p of W_ih1[d][k, n], and the pieces sum back to W."""
    rng = np.random.default_rng(hidden)
    w_f, w_b = (torch.from_numpy(rng.standard_normal((hidden, 3 * hidden)).astype(np.float32))
                for _ in range(2))
    packed = ek.pack_f32_gate_pieces(w_f, w_b)
    assert packed.shape == (2, 3, hidden // 32, hidden // 64, 96, 64)
    torch.testing.assert_close(packed, torch.stack([tk.pack_fwd_weights(w_f),
                                                    tk.pack_fwd_weights(w_b)]), rtol=0, atol=0)
    w = torch.from_numpy(rng.standard_normal((2, 2 * hidden, 3 * hidden)).astype(np.float32))
    pieces = ek.split_weight_pieces(w)
    assert pieces.shape == (2, 3, 3 * hidden, 2 * hidden) and pieces.dtype == torch.bfloat16
    assert pieces.is_contiguous()
    for d in range(2):
        hi, mid, lo = kc.split_bf16_pieces(w[d])
        for p, piece in enumerate((hi, mid, lo)):
            torch.testing.assert_close(pieces[d, p], piece.t(), rtol=0, atol=0)
    back = pieces.double().sum(dim=1).transpose(1, 2)
    assert ((back - w.double()).abs() <= 2.0 ** -24 * w.double().abs()).all()


@pytest.mark.parametrize("hidden,linear,sizes,rows,slots,cluster", [
    (256, 256, [2, 4, 8], 512, None, 8), (256, 256, [2, 4, 8], 1, None, 8),
    (256, 256, [2, 4, 8], 1024, {2: 66, 4: 30, 8: 15}, 4), (64, 12, [1, 2], 37, None, 2),
    (128, 64, [1, 2, 4], 64, None, 4), (512, 256, [4, 8], 512, None, 8)])
def test_arnn_f32_plan(hidden, linear, sizes, rows, slots, cluster):
    """K7's f32 route: CTAs own whole 32-unit rounds (two 16-unit chunks, one
    a consumer warpgroup), at most four, beside two 72 KB ring stages and
    their f32 c carries; the plan takes the least modelled time (one wave of
    clusters of 8 at the flagship's batch 512; 1,024 rows on an H100's
    slots take 4)."""
    lp = ak.arnn_head_width(linear)
    assert ak.arnn_f32_cluster_sizes(hidden, lp) == sizes
    for c in sizes:
        assert ak.arnn_f32_smem_bytes(hidden, c) <= kc.HOPPER_SMEM_BUDGET
        assert (hidden // c) % 32 == 0 and hidden // c <= 128
    plan = ak.arnn_f32_plan(rows, hidden, linear, SMS, slots)
    assert plan == kc.LaunchPlan(cluster, 2)


def test_arnn_f32_gate_and_first_kernel_geometries():
    """The f32 route takes the flagship and H 64 at any vocabulary and head
    width, and H 320 on clusters of 5; no geometry the gate takes runs the
    first kernel (two CUDA launches a call), and a width the route cannot
    split is refused."""
    assert ak.arnn_f32_supports(256, 256, 60) and ak.arnn_f32_supports(64, 12, 30)
    assert ak.arnn_f32_supports(512, 256, 60)
    assert ak.arnn_f32_supports(256, 256, 65) and ak.arnn_f32_supports(256, 600, 60)
    assert ak.arnn_f32_cluster_sizes(320, 256) == [5]
    assert ak.arnn_f32_cluster_sizes(96, 128) == []
    assert ak.arnn_kernel_supports(256, 256, 256, 65, torch.float32)
    assert ak.arnn_kernel_supports(96, 256, 256, 60, torch.float32)  # at 128, on zero units
    assert ak.arnn_cuda_launches(torch.float32, 70, 384, 64, 12, 30) == 2
    assert ak.arnn_cuda_launches(torch.float32, 70, 384, 64, 12, 65) == 2
    with pytest.raises(ValueError, match="hidden size 96"):
        ak.arnn_f32_plan(64, 96, 256, SMS)


def test_pack_arnn_f32_weights_layout():
    """Six 64 x 64 blocks a k-slab of a pair of chunks, [piece][chunk]:
    the LSTM weights' chunk c row 16 g + u is gate g's column of unit 16 c +
    u; W_l1^T in rounds of 128 hidden columns (zero past L); W_out^T's 64
    columns (zero past V and L) beside a zero chunk."""
    hidden, linear, vocab = 64, 100, 30
    rng = np.random.default_rng(17)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w_hh0, w_ih1, w_hh1 = (rand(hidden, 4 * hidden) for _ in range(3))
    w_l1, w_out = rand(hidden, linear), rand(linear, vocab)
    packed = ak.pack_arnn_f32_weights(w_hh0, w_ih1, w_hh1, w_l1, w_out)
    kb, lp, pairs = hidden // 64, ak.arnn_head_width(linear), hidden // 32
    lstm_blocks = pairs * kb * 6
    assert packed.shape == (3 * lstm_blocks + lp // 128 * kb * 6 + lp // 64 * 6, 64, 64)
    assert packed.dtype == torch.bfloat16

    def block(base, pair, k, p, chunk, slabs):
        return packed[base + (pair * slabs + k) * 6 + 2 * p + chunk].float()
    for i, w in enumerate((w_hh0, w_ih1, w_hh1)):
        pieces = kc.split_bf16_pieces(w)
        for c in range(hidden // 16):
            for k in range(kb):
                for p in range(3):
                    got = block(i * lstm_blocks, c // 2, k, p, c % 2, kb)
                    for g in range(4):
                        want = pieces[p][64 * k: 64 * k + 64,
                                         g * hidden + 16 * c: g * hidden + 16 * c + 16].t()
                        torch.testing.assert_close(got[16 * g: 16 * g + 16], want.float(),
                                                   rtol=0, atol=0)
    l1 = torch.zeros(hidden, lp)
    l1[:, :linear] = w_l1
    l1_pieces = kc.split_bf16_pieces(l1)
    for hr in range(lp // 128):
        for k in range(kb):
            for p in range(3):
                for chunk in range(2):
                    cols = slice(128 * hr + 64 * chunk, 128 * hr + 64 * chunk + 64)
                    want = l1_pieces[p][64 * k: 64 * k + 64, cols].t()
                    torch.testing.assert_close(block(3 * lstm_blocks, hr, k, p, chunk, kb),
                                               want.float(), rtol=0, atol=0)
    out = torch.zeros(lp, 128)
    out[:linear, :vocab] = w_out
    out_pieces = kc.split_bf16_pieces(out)
    base = 3 * lstm_blocks + lp // 128 * kb * 6
    for k in range(lp // 64):
        for p in range(3):
            want = out_pieces[p][64 * k: 64 * k + 64, :64].t()
            torch.testing.assert_close(block(base, 0, k, p, 0, lp // 64), want.float(),
                                       rtol=0, atol=0)
            assert not block(base, 0, k, p, 1, lp // 64).any()


# chip_smoke.py's f32 bounds of K1's h_n and of K7's decode against their
# plain versions, which the planted faults must break
K1_F32_HN = 1e-6
K7_F32 = {"tokens": 0.999, "max": 1e-6, "mean": 1e-7}


def _encoder_f32_case(batch=24, hidden=64, seed=19):
    from inpaintnet_tpu_torch.ops.gru import gru_init
    from inpaintnet_tpu_torch.ops.linear import embedding_init

    rng = np.random.default_rng(seed)

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [tensors(v) for v in tree]
        return torch.from_numpy(np.asarray(tree, np.float32))
    gru = tensors(gru_init(rng, 10, hidden, 2, True))
    table = tensors(embedding_init(rng, 61, 10)["table"])
    tokens = torch.from_numpy(rng.integers(0, 61, (batch, 24)).astype(np.int32))
    return gru, table, tokens


def test_k1_f32_planted_faults_break_the_f32_bound(monkeypatch):
    """The two faults chip_smoke.py plants in K1's f32 plain versions move
    h_n past the f32 bound at the encoder's init scale: the product on h
    taken as one bf16 piece, and layer 1's projection rounded to bf16."""
    gru, table, tokens = _encoder_f32_case()
    want = ek.encoder_hn_reference(gru, table, tokens)
    torch.testing.assert_close(ek.encoder_hn_staged_reference(gru, table, tokens), want,
                               rtol=0, atol=K1_F32_HN / 10)
    monkeypatch.setattr(ek, "recurrent_product", lambda h, w: h.bfloat16().float() @ w)
    one_piece = ek.encoder_hn_reference(gru, table, tokens)
    monkeypatch.undo()
    exact = ek.input_projection_reference
    monkeypatch.setattr(ek, "input_projection_reference",
                        lambda ys, w, b: exact(ys, w, b).bfloat16().float())
    rounded = ek.encoder_hn_staged_reference(gru, table, tokens)
    for planted in (one_piece, rounded):
        assert (planted - want).abs().max().item() > K1_F32_HN


def _arnn_f32_case(batch=8, ticks=48, hidden=64, ctx=64, emb=10, linear=12, vocab=30, seed=23):
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=hidden ** -0.5):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    params = {"note_embedding": {"table": rand(vocab + 1, emb, scale=1.0)},
              "lstm_generation": [{"w_ih": rand(k, 4 * hidden), "w_hh": rand(hidden, 4 * hidden),
                                   "b_ih": rand(4 * hidden), "b_hh": rand(4 * hidden)}
                                  for k in (emb + ctx, hidden)],
              "linear_1": {"w": rand(hidden, linear), "b": rand(linear)},
              "linear_output_notes": {"w": rand(linear, vocab, scale=linear ** -0.5),
                                      "b": rand(vocab)}}
    force = torch.from_numpy((rng.uniform(size=(batch, ticks)) < 0.5).astype(np.int32))
    score = torch.from_numpy(rng.integers(0, vocab, (batch, ticks)).astype(np.int32))
    return (params, rand(batch, ticks, ctx, scale=0.5), score, force, rand(1, emb, scale=1.0))


def test_k7_f32_planted_faults_break_the_f32_bounds(monkeypatch):
    """The two faults chip_smoke.py plants in K7's f32 plain versions break
    the f32 bounds: the products on h taken as one bf16 piece, and the
    context projection rounded to bf16; the staged plain version (the
    route's staging) stays within them."""
    args = _arnn_f32_case()
    want = ak.arnn_sampled_decode_reference(*args)
    assert ak.within(ak.decode_agreement(ak.arnn_sampled_decode_staged_reference(*args), want,
                                         args[3]), K7_F32)
    monkeypatch.setattr(ak, "recurrent_product", lambda h, w: h.bfloat16().float() @ w)
    faults = [ak.arnn_sampled_decode_reference(*args)]
    monkeypatch.undo()
    projection = ak.ctx_projection
    monkeypatch.setattr(ak, "ctx_projection",
                        lambda ctx, w: projection(ctx, w).bfloat16().float())
    faults.append(ak.arnn_sampled_decode_staged_reference(*args))
    for planted in faults:
        assert not ak.within(ak.decode_agreement(planted, want, args[3]), K7_F32)
