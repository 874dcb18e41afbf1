#!/usr/bin/env python3
"""Drive the PyTorch port's serving main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device: a CUDA card of compute capability 9.0 (Hopper); prints its name
   and power limit;
2. build: compiles the CUDA kernels (``inpaintnet_tpu_torch/ops/csrc``)
   with nvcc for sm_90a;
3. each kernel (K1 ``encoder_hn``, K2 ``decode_sampling``) against its
   plain PyTorch version on the card, at the shapes the engine gives them
   for a batch of 2048 requests, in f32 and bf16;
4. the engine (flagship geometry, random weights from seed 0, bf16) serves
   three requests; their outputs are checked, the f32 path is held against
   the plain versions on the CPU on a small input, and the kernels' launch
   counters must have risen;
5. times: measures/s at batch 2048 (6 past / 4 target / 6 future), the p50
   of a batch-1 request, and each kernel beside its plain version.

Prints one JSON line of kernels, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits nonzero, printing no
result, when there is no usable card or any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BUCKETS = (1, 8, 64, 512, 2048)
BATCH = 2048
N_PAST, N_TARGET, N_FUTURE = 6, 4, 6
N_BARS = 16  # the engine pads past and future to n_bars measures each
VOCAB = 60

# Bounds of kernel vs plain version on the card. Both accumulate in f32
# and differ only in summation order; in bf16 that order can flip a carry
# rounding, which then propagates. Seen on an H100 (700 W) at these shapes:
# f32 h_n 1.5e-8, tokens 0.999993, logits 6e-7; bf16 h_n 2.4e-4, tokens
# 0.99984, logits 7.8e-3. The bounds keep a margin over that:
# - f32: h_n 1e-6, tokens equal on >= 99.99% (argmax near-ties), logits 1e-5;
# - bf16: h_n 8e-3 (two bf16 ulps of |h| < 1), tokens >= 99.9%, logits 3e-2
#   (two ulps of logits up to 4) where both decodes fed back the same tokens.
BOUNDS = {
    torch.float32: {"hn": 1e-6, "tokens": 0.9999, "logits": 1e-5},
    torch.bfloat16: {"hn": 8e-3, "tokens": 0.999, "logits": 3e-2},
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper), got {cap}")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from inpaintnet_tpu_torch.ops.kernel_common import build_kernels, load_kernels

    t0 = time.perf_counter()
    lib = build_kernels(verbose=True)
    load_kernels()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)


def _first_divergence_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(rows, 24) bool: ticks up to and including a row's first token
    mismatch, where both decodes have fed back the same tokens."""
    same = (a == b).int()
    seen = torch.cumprod(same, dim=1)
    return torch.cat([torch.ones_like(seen[:, :1]), seen[:, :-1]], dim=1).bool()


def phase_kernels(vae_f32, max_target: int, card: str) -> dict:
    """K1 and K2 against their plain versions at the engine's shapes."""
    from inpaintnet_tpu_torch.models.measure_vae import NUM_BEATS_PER_MEASURE
    from inpaintnet_tpu_torch.ops.decode_kernel import decode_sampling, decode_sampling_reference
    from inpaintnet_tpu_torch.ops.encoder_kernel import encoder_hn, encoder_hn_reference
    from inpaintnet_tpu_torch.ops.linear import linear_apply
    from inpaintnet_tpu_torch.models.base import cast_params

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    enc_rows = BATCH * 2 * N_BARS
    dec_rows = BATCH * max_target  # the engine decodes max_target rows per request
    tokens = torch.from_numpy(rng.integers(0, VOCAB, (enc_rows, 24)).astype(np.int32)).to(dev)
    z = torch.from_numpy(rng.standard_normal((dec_rows, vae_f32.latent_space_dim))
                         .astype(np.float32)).to(dev)
    params32 = vae_f32.params()
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        bound = BOUNDS[dtype]
        p = cast_params(params32, dev, dtype)
        enc, dec = p["encoder"], p["decoder"]
        hn_k = encoder_hn(enc["gru"], enc["embedding"]["table"], tokens)
        hn_p = encoder_hn_reference(enc["gru"], enc["embedding"]["table"], tokens)
        torch.cuda.synchronize()
        hn_err = (hn_k.float() - hn_p.float()).abs().max().item()

        beat_out = vae_f32.decoder._beat_outputs(dec, z.to(dtype))
        tick_ctx = torch.selu(linear_apply(dec["beat_to_tick_input"], beat_out)).contiguous()
        h_inits = vae_f32.decoder._tick_h0(
            dec, beat_out.reshape(dec_rows * NUM_BEATS_PER_MEASURE, -1)
        ).reshape(2, dec_rows, NUM_BEATS_PER_MEASURE, -1).contiguous()
        lg_k, s_k = decode_sampling(dec, tick_ctx, h_inits)
        lg_p, s_p = decode_sampling_reference(dec, tick_ctx, h_inits)
        torch.cuda.synchronize()
        agree = (s_k == s_p).float().mean().item()
        seen = _first_divergence_mask(s_k, s_p)
        lg_err = (lg_k.float() - lg_p.float()).abs()[seen].max().item()
        name = str(dtype).replace("torch.", "")
        print(f"[kernels] {name}: K1 rows {enc_rows} h_n max_abs_err {hn_err:.3e} "
              f"(bound {bound['hn']}); K2 rows {dec_rows} tokens equal {agree:.6f} "
              f"(bound {bound['tokens']}), logits max_abs_err {lg_err:.3e} where the "
              f"fed-back tokens agree (bound {bound['logits']})", flush=True)
        if not (hn_err <= bound["hn"] and agree >= bound["tokens"]
                and lg_err <= bound["logits"]):
            raise RuntimeError(f"kernel disagrees with its plain version in {name}")
        if not (bool(torch.isfinite(hn_k.float()).all()) and bool(torch.isfinite(lg_k.float()).all())):
            raise RuntimeError(f"non-finite kernel output in {name}")
        if dtype is torch.bfloat16:  # the serving dtype: times at these shapes
            report["encoder_hn"] = {
                "max_abs_err": hn_err,
                "ms": cuda_ms(lambda: encoder_hn(enc["gru"], enc["embedding"]["table"], tokens), 5),
                "plain_ms": cuda_ms(lambda: encoder_hn_reference(
                    enc["gru"], enc["embedding"]["table"], tokens), 3),
            }
            report["decode_sampling"] = {
                "max_abs_err": lg_err,
                "ms": cuda_ms(lambda: decode_sampling(dec, tick_ctx, h_inits), 5),
                "plain_ms": cuda_ms(lambda: decode_sampling_reference(dec, tick_ctx, h_inits), 3),
            }
            for k, v in report.items():
                print(f"[time] {k} bf16: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms "
                      f"| {card}", flush=True)
    return report


def _request(rng, batch: int, n_past: int, n_target: int, n_future: int):
    m = n_past + n_target + n_future
    return rng.integers(0, VOCAB, (batch, m, 24)).astype(np.int32), n_past, n_target


def _check_response(out, tokens, start: int, num: int):
    if out.shape != tokens.shape:
        raise RuntimeError(f"response shape {out.shape} != request {tokens.shape}")
    if out.min() < 0 or out.max() >= VOCAB:
        raise RuntimeError("response tokens outside [0, vocab)")
    keep = np.ones(tokens.shape[1], bool)
    keep[start:start + num] = False
    if not np.array_equal(out[:, keep], tokens[:, keep]):
        raise RuntimeError("tokens outside the span changed")


def phase_engine(model, card: str) -> dict:
    from inpaintnet_tpu_torch.ops.decode_kernel import decode_sampling
    from inpaintnet_tpu_torch.ops.encoder_kernel import encoder_hn
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    engine = InpaintingEngine(model, batch_buckets=BUCKETS, dtype="bfloat16", device="cuda")
    engine.warmup()
    rng = np.random.default_rng(2)
    requests = [
        ("batch 1, 2-measure span", *_request(rng, 1, 7, 2, 7)),
        ("batch 8, 6/4/6", *_request(rng, 8, N_PAST, N_TARGET, N_FUTURE)),
        (f"batch {BATCH}, 6/4/6", *_request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE)),
    ]
    encoder_hn.launches = 0
    decode_sampling.launches = 0
    for label, tokens, start, num in requests:
        out = engine.inpaint(tokens, start, num, seed=11)
        _check_response(out, tokens, start, num)
        if not np.array_equal(out, engine.inpaint(tokens, start, num, seed=11)):
            raise RuntimeError(f"{label}: the same seed gave different tokens")
        changed = (out[:, start:start + num] != tokens[:, start:start + num]).mean()
        print(f"[engine] {label}: ok, {changed:.3f} of span tokens differ from the input",
              flush=True)
    launches = {"encoder_hn": encoder_hn.launches, "decode_sampling": decode_sampling.launches}
    print(f"[engine] kernel launches during the requests: {launches}", flush=True)
    if min(launches.values()) < 1:
        raise RuntimeError(f"the main path did not launch every kernel: {launches}")

    tokens, start, num = requests[2][1:]
    t_big = cuda_ms(lambda: engine.inpaint(tokens, start, num, seed=5), 5)
    one, s1, n1 = requests[0][1:]
    lat = [cuda_ms(lambda: engine.inpaint(one, s1, n1, seed=5), 1) for _ in range(20)]
    rate = BATCH * N_TARGET / (t_big / 1e3)
    print(f"[time] engine bf16 batch {BATCH} 6/4/6: {t_big:.2f} ms per call, "
          f"{rate:.1f} measures/s | {card}", flush=True)
    print(f"[time] engine bf16 batch 1 2-measure: p50 {np.median(lat):.2f} ms "
          f"(p90 {np.percentile(lat, 90):.2f} ms) | {card}", flush=True)
    return launches


def phase_reference(model):
    """The f32 main path on the card (kernels) against the same model on
    the CPU (plain versions) on a small input with shared noise."""
    from inpaintnet_tpu_torch.models.base import cast_params

    rng = np.random.default_rng(3)
    b, m = 4, 2 * N_BARS
    past = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    future = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    pm = (np.arange(N_BARS) < N_PAST)[None].repeat(b, 0).astype(np.float32)
    fm = (np.arange(N_BARS) < N_FUTURE)[None].repeat(b, 0).astype(np.float32)
    fm[0] = 0  # a row with no future context
    tm = (np.arange(model.max_target) < N_TARGET)[None].repeat(b, 0).astype(np.float32)
    eps = rng.standard_normal((b * m, model.z_dim)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        params = cast_params(model.params(), dev, torch.float32)
        vae_params = cast_params(model.vae_model.params(), dev, torch.float32)
        args = [torch.from_numpy(a).to(dev) for a in (past, future, pm, fm, tm, eps)]
        with torch.inference_mode():
            lg, s, z = model.apply(params, vae_params, args[0], args[1], None,
                                   past_mask=args[2], future_mask=args[3],
                                   target_mask=args[4], eps=args[5])
        outs[dev] = (lg.float().cpu(), s.cpu(), z.float().cpu())
    z_err = (outs["cuda"][2] - outs["cpu"][2]).abs().max().item()
    agree = (outs["cuda"][1] == outs["cpu"][1]).float().mean().item()
    ok = bool(torch.isfinite(outs["cuda"][0]).all())
    print(f"[reference] f32 main path, card vs CPU plain: gen z max_abs_err {z_err:.3e} "
          f"(bound 1e-3), tokens equal {agree:.4f} (bound 0.99), finite {ok}", flush=True)
    if not (z_err <= 1e-3 and agree >= 0.99 and ok):
        raise RuntimeError("the main path on the card disagrees with the CPU reference")


def main() -> int:
    card = phase_device()
    phase_build()
    from inpaintnet_tpu_torch.models.presets import build_flagship

    _, vae, model = build_flagship(seed=0, device="cuda", dtype=torch.float32)
    report = phase_kernels(vae, model.max_target, card)
    phase_reference(model)
    launches = phase_engine(model, card)
    kernels = [
        {"name": "encoder_hn", "route": "cuda",
         "source": "inpaintnet_tpu_torch/ops/csrc/encoder_gru.cu",
         "replaces": "inpaintnet_tpu/ops/encoder_pallas.py:147",
         "launches": launches["encoder_hn"], **report["encoder_hn"]},
        {"name": "decode_sampling", "route": "cuda",
         "source": "inpaintnet_tpu_torch/ops/csrc/decode_sampling.cu",
         "replaces": "inpaintnet_tpu/ops/decode_pallas.py:216",
         "launches": launches["decode_sampling"], **report["decode_sampling"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
