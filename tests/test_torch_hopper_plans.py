"""The Python side of the Hopper routes of K8 and K2 (``csrc/gru_layer_hopper.cuh``,
``csrc/decode_hopper.cuh``), which the CPU can check: the launch plans at
the engines' row counts and the CTAs they launch, the packed weight
layouts against the unpacked weights, and the per-weight operand cache."""
import numpy as np
import pytest
import torch

from inpaintnet_tpu_torch.ops import decode_kernel as dk
from inpaintnet_tpu_torch.ops import encoder_kernel as ek
from inpaintnet_tpu_torch.ops import gru_kernel as gk
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
    cluster split, so the bf16 route rejects it and the f32 route takes it."""
    for hidden, tiles in ((512, 1), (1024, 1), (512, 2), (64, 2), (192, 1)):
        stages = kc.ring_stages(hidden, tiles)
        used = tiles * 64 * hidden * 2 + 2 * stages * kc.box_slabs(hidden) * 96 * 128 + 1024
        assert 2 <= stages <= 6 and used <= kc.HOPPER_SMEM_BUDGET
    assert [kc.box_slabs(h) for h in (64, 128, 192, 512, 1024)] == [1, 2, 1, 2, 2]
    assert kc.cluster_sizes(1024) == [2, 4, 8] and kc.cluster_sizes(576) == []
    with pytest.raises(ValueError, match="hidden size 576"):
        gk.launch_plan(64, 576, SMS)
    assert not kc.gru_layer_supports_hidden(576, torch.bfloat16)
    assert kc.gru_layer_supports_hidden(576, torch.float32)
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
        assert fresh["head_b"].shape == ((64,) if dtype == torch.bfloat16 else (16,))


def test_weight_cache_counts_no_versions_of_inference_tensors():
    calls = []
    cache = kc.WeightCache(lambda w: calls.append(w) or len(calls))
    with torch.inference_mode():
        w = torch.ones(4)
    assert cache(w) == 1 and cache(w) == 2  # rebuilt: an update could not be seen
    v = torch.ones(4)
    assert cache(v) == 3 and cache(v) == 3
