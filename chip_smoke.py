#!/usr/bin/env python3
"""Drive the PyTorch port's serving main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device: a CUDA card of compute capability 9.0 (Hopper); prints its name
   and power limit;
2. build: compiles the CUDA kernels (``inpaintnet_tpu_torch/ops/csrc``)
   with nvcc for sm_90a, one nvcc per source, in parallel;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the engine gives them for a batch of 2048 requests: K1
   ``encoder_hn`` and K2 ``decode_sampling`` in f32 and bf16, K3
   ``encoder_hn_int8`` and K4 ``decode_sampling_int8`` on bf16 masters
   (bit-equal; each of their two traps, planted in the plain versions,
   must break that bound);
4. the main path on the card against the same model on the CPU (plain
   versions) on a small input, f32 masters: unquantized, and int8, whose
   bounds the unquantized path must fail;
5. the bf16 engine (flagship geometry, random weights from seed 0) serves
   three requests, checked; K1 and K2 must have launched;
6. the int8 engine serves the same three requests, checked; K3 and K4 must
   have launched; the share of span tokens on which int8 and bf16 agree is
   printed (random weights set no limit on it);
7. HTTP: ``inpaintnet_tpu.server.InpaintingServer`` (the shared numpy-only
   front end; no JAX) in front of the int8 engine, dynamic batching pinned
   to bucket 64: 16 concurrent clients' ``/v1/inpaint`` responses must
   equal the engine's solo ``inpaint_hetero``, variation 0 of
   ``/v1/inpaint_variations`` the seeded ``/v1/inpaint``, and
   ``/v1/inpaint_ticks``, ``/v1/interpolate`` and ``/healthz`` must answer;
   K3 and K4 must have launched;
8. times: measures/s at batch 2048 (6 past / 4 target / 6 future) and the
   p50/p90 of a batch-1 request for each engine, and each kernel beside its
   plain version.

Prints one JSON line of kernels, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits nonzero, printing no
result, when there is no usable card or any phase fails.
"""
from __future__ import annotations

import http.client
import json
import subprocess
import sys
import threading
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
# K3/K4 against their plain versions: bit-equal. Both take exact int32
# products, and the kernels round every f32 multiply and add, and every exp
# and tanh, as the plain versions' PyTorch CUDA ops do (seen: 0.0 at these
# shapes). Anything looser would pass the two traps of these kernels, which
# differ from them by less than one int8 quantum; phase 3 plants both and
# checks that these bounds reject them.
BOUNDS_INT8 = {"hn": 0.0, "tokens": 1.0, "logits": 0.0}
# The int8 main path on the card against the CPU (f32 masters): gate ulps of
# the two devices' exp/tanh flip a few carry roundings, each of which moves
# one row's z. Seen on an H100 (700 W): median 2.9e-5, max 9.6e-4; the
# unquantized path on the card against the CPU's int8 (the control, which
# must fail both bounds in every run): median 4.6e-4, max 3.8e-3.
Z_MEDIAN_INT8, Z_MAX_INT8 = 1e-4, 2e-3


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


def _reject_planted_faults(dec, gru, table, tokens, tick_ctx, h_inits, hn_k, lg_k, s_k):
    """The two traps of K3 and K4, planted in their plain versions, must
    break ``BOUNDS_INT8`` against the kernels: an h_n taken from the
    dequantized int8 carry instead of the f32 state, and a fed-back token
    projection that skips its rounding to bf16."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops.quantize import dequantize_h

    _, ys = ek.encoder_int8_layers_reference(gru, table, tokens)
    # layer 0's last carries: forward at t = T-1, backward at t = 0
    planted = torch.stack([dequantize_h(ys[0, -1]), dequantize_h(ys[1, 0])]).to(hn_k.dtype)
    hn_err = (hn_k[:2].float() - planted.float()).abs().max().item()
    rounded = dk.fed_back_xw
    dk.fed_back_xw = lambda ops, tok, dtype: ops["tok_q"][tok].float() * ops["scales"][3]
    try:
        lg_p, s_p = dk.decode_sampling_int8_reference(dec, tick_ctx, h_inits)
    finally:
        dk.fed_back_xw = rounded
    torch.cuda.synchronize()
    agree = (s_k == s_p).float().mean().item()
    lg_err = (lg_k.float() - lg_p.float()).abs()[_first_divergence_mask(s_k, s_p)].max().item()
    print(f"[kernels] int8 planted faults: h_n from the dequantized carry max_abs_err "
          f"{hn_err:.3e}; unrounded token feedback tokens equal {agree:.6f}, logits "
          f"max_abs_err {lg_err:.3e}", flush=True)
    b = BOUNDS_INT8
    if hn_err <= b["hn"] or (agree >= b["tokens"] and lg_err <= b["logits"]):
        raise RuntimeError("a planted K3/K4 fault passes the int8 bounds")


def phase_kernels(vae_f32, max_target: int, card: str) -> dict:
    """Each kernel against its plain version at the engine's batch-2048
    shapes: K1/K2 in f32 and bf16, K3/K4 on bf16 masters (the int8 engine's)."""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.models.measure_vae import NUM_BEATS_PER_MEASURE
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops.linear import linear_apply

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    enc_rows = BATCH * 2 * N_BARS
    dec_rows = BATCH * max_target  # the engine decodes max_target rows per request
    tokens = torch.from_numpy(rng.integers(0, VOCAB, (enc_rows, 24)).astype(np.int32)).to(dev)
    z = torch.from_numpy(rng.standard_normal((dec_rows, vae_f32.latent_space_dim))
                         .astype(np.float32)).to(dev)
    params32 = vae_f32.params()
    cases = [  # (label, masters, K-enc, plain, K-dec, plain, bounds, report names or None)
        ("float32", torch.float32, ek.encoder_hn, ek.encoder_hn_reference,
         dk.decode_sampling, dk.decode_sampling_reference, BOUNDS[torch.float32], None),
        ("bfloat16", torch.bfloat16, ek.encoder_hn, ek.encoder_hn_reference,
         dk.decode_sampling, dk.decode_sampling_reference, BOUNDS[torch.bfloat16],
         ("encoder_hn", "decode_sampling")),
        ("int8", torch.bfloat16, ek.encoder_hn_int8, ek.encoder_hn_int8_reference,
         dk.decode_sampling_int8, dk.decode_sampling_int8_reference, BOUNDS_INT8,
         ("encoder_hn_int8", "decode_sampling_int8")),
    ]
    report = {}
    for label, dtype, enc_k, enc_p, dec_k, dec_p, bound, names in cases:
        p = cast_params(params32, dev, dtype)
        enc, dec = p["encoder"], p["decoder"]
        gru, table = enc["gru"], enc["embedding"]["table"]
        hn_k = enc_k(gru, table, tokens)
        hn_p = enc_p(gru, table, tokens)
        torch.cuda.synchronize()
        hn_err = (hn_k.float() - hn_p.float()).abs().max().item()

        beat_out = vae_f32.decoder._beat_outputs(dec, z.to(dtype))
        tick_ctx = torch.selu(linear_apply(dec["beat_to_tick_input"], beat_out)).contiguous()
        h_inits = vae_f32.decoder._tick_h0(
            dec, beat_out.reshape(dec_rows * NUM_BEATS_PER_MEASURE, -1)
        ).reshape(2, dec_rows, NUM_BEATS_PER_MEASURE, -1).contiguous()
        lg_k, s_k = dec_k(dec, tick_ctx, h_inits)
        lg_p, s_p = dec_p(dec, tick_ctx, h_inits)
        torch.cuda.synchronize()
        agree = (s_k == s_p).float().mean().item()
        seen = _first_divergence_mask(s_k, s_p)
        lg_err = (lg_k.float() - lg_p.float()).abs()[seen].max().item()
        print(f"[kernels] {label}: {enc_k.__name__} rows {enc_rows} h_n max_abs_err "
              f"{hn_err:.3e} (bound {bound['hn']:.3e}); {dec_k.__name__} rows {dec_rows} "
              f"tokens equal {agree:.6f} (bound {bound['tokens']}), logits max_abs_err "
              f"{lg_err:.3e} where the fed-back tokens agree (bound {bound['logits']})",
              flush=True)
        if not (hn_err <= bound["hn"] and agree >= bound["tokens"]
                and lg_err <= bound["logits"]):
            raise RuntimeError(f"kernel disagrees with its plain version in {label}")
        if not (bool(torch.isfinite(hn_k.float()).all())
                and bool(torch.isfinite(lg_k.float()).all())):
            raise RuntimeError(f"non-finite kernel output in {label}")
        if label == "int8":
            _reject_planted_faults(dec, gru, table, tokens, tick_ctx, h_inits, hn_k, lg_k, s_k)
        if names is None:
            continue
        # the serving numerics: times at these shapes (plain versions: few reps)
        enc_name, dec_name = names
        report[enc_name] = {"max_abs_err": hn_err,
                            "ms": cuda_ms(lambda: enc_k(gru, table, tokens), 5),
                            "plain_ms": cuda_ms(lambda: enc_p(gru, table, tokens), 2)}
        report[dec_name] = {"max_abs_err": lg_err,
                            "ms": cuda_ms(lambda: dec_k(dec, tick_ctx, h_inits), 5),
                            "plain_ms": cuda_ms(lambda: dec_p(dec, tick_ctx, h_inits), 2)}
        for k in names:
            v = report[k]
            print(f"[time] {k} {label}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms "
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


def _kernels_of(dtype: str):
    from inpaintnet_tpu_torch.ops import decode_kernel, encoder_kernel

    if dtype == "int8":
        return encoder_kernel.encoder_hn_int8, decode_kernel.decode_sampling_int8
    return encoder_kernel.encoder_hn, decode_kernel.decode_sampling


def _launches_during(kernels, fn):
    """Run ``fn()`` with the kernels' launch counts set to 0; -> (its
    result, {name: launches}); raises if a kernel never launched."""
    for k in kernels:
        k.launches = 0
    out = fn()
    launches = {k.__name__: k.launches for k in kernels}
    if min(launches.values()) < 1:
        raise RuntimeError(f"the path did not launch every kernel: {launches}")
    return out, launches


def phase_engine(model, dtype: str, card: str):
    """One engine serves three requests (checked), then the times. ->
    (engine, {kernel: launches}, the batch-2048 response)."""
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    engine = InpaintingEngine(model, batch_buckets=BUCKETS, dtype=dtype, device="cuda")
    engine.warmup()
    rng = np.random.default_rng(2)
    requests = [
        ("batch 1, 2-measure span", *_request(rng, 1, 7, 2, 7)),
        ("batch 8, 6/4/6", *_request(rng, 8, N_PAST, N_TARGET, N_FUTURE)),
        (f"batch {BATCH}, 6/4/6", *_request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE)),
    ]

    def serve():
        outs = []
        for label, tokens, start, num in requests:
            out = engine.inpaint(tokens, start, num, seed=11)
            _check_response(out, tokens, start, num)
            if not np.array_equal(out, engine.inpaint(tokens, start, num, seed=11)):
                raise RuntimeError(f"{label}: the same seed gave different tokens")
            changed = (out[:, start:start + num] != tokens[:, start:start + num]).mean()
            print(f"[engine] {dtype} {label}: ok, {changed:.3f} of span tokens differ from "
                  f"the input", flush=True)
            outs.append(out)
        return outs

    outs, launches = _launches_during(_kernels_of(dtype), serve)
    print(f"[engine] {dtype} kernel launches during the requests: {launches}", flush=True)

    tokens, start, num = requests[2][1:]
    t_big = cuda_ms(lambda: engine.inpaint(tokens, start, num, seed=5), 5)
    one, s1, n1 = requests[0][1:]
    lat = [cuda_ms(lambda: engine.inpaint(one, s1, n1, seed=5), 1) for _ in range(20)]
    rate = BATCH * N_TARGET / (t_big / 1e3)
    print(f"[time] engine {dtype} batch {BATCH} 6/4/6: {t_big:.2f} ms per call, "
          f"{rate:.1f} measures/s | {card}", flush=True)
    print(f"[time] engine {dtype} batch 1 2-measure: p50 {np.median(lat):.2f} ms "
          f"(p90 {np.percentile(lat, 90):.2f} ms) | {card}", flush=True)
    return engine, launches, outs[2][:, start:start + num]


def phase_reference(model):
    """The main path on the card (kernels) against the same model on the
    CPU (plain versions) on a small input with shared noise, f32 masters:
    unquantized (z and tokens), and int8 (z, by median and max; the random
    weights' near-flat logits turn a flipped carry rounding into other
    argmax tokens, so the token share is printed). The unquantized path on
    the card against the int8 path on the CPU must fail both int8 bounds,
    or they could not tell the two apart. K3 and K4 at the engine's bf16
    masters are held to their plain versions in phase 3."""
    from inpaintnet_tpu_torch.models.base import cast_params

    rng = np.random.default_rng(3)
    b = 4
    past = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    future = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    pm = (np.arange(N_BARS) < N_PAST)[None].repeat(b, 0).astype(np.float32)
    fm = (np.arange(N_BARS) < N_FUTURE)[None].repeat(b, 0).astype(np.float32)
    fm[0] = 0  # a row with no future context
    tm = (np.arange(model.max_target) < N_TARGET)[None].repeat(b, 0).astype(np.float32)
    eps = rng.standard_normal((b * 2 * N_BARS, model.z_dim)).astype(np.float32)

    def run(dev, quant):
        params = cast_params(model.params(), dev, torch.float32)
        vae_params = cast_params(model.vae_model.params(), dev, torch.float32)
        args = [torch.from_numpy(a).to(dev) for a in (past, future, pm, fm, tm, eps)]
        with torch.inference_mode():
            lg, s, z = model.apply(params, vae_params, args[0], args[1], None,
                                   past_mask=args[2], future_mask=args[3],
                                   target_mask=args[4], eps=args[5], quant=quant)
        return lg.cpu(), s.cpu(), z.cpu()

    outs = {(dev, quant): run(dev, quant) for quant in ("none", "int8") for dev in ("cuda", "cpu")}

    def compare(card_quant, cpu_quant):
        (lg, s, z), (_, s_cpu, z_cpu) = outs["cuda", card_quant], outs["cpu", cpu_quant]
        err = (z - z_cpu).abs()
        return (err.max().item(), err.median().item(), (s == s_cpu).float().mean().item(),
                bool(torch.isfinite(lg).all()))

    z_max, _, agree, ok = compare("none", "none")
    print(f"[reference] f32 main path, card vs CPU plain: gen z max_abs_err {z_max:.3e} "
          f"(bound 1e-3), tokens equal {agree:.4f} (bound 0.99), finite {ok}", flush=True)
    if not (z_max <= 1e-3 and agree >= 0.99 and ok):
        raise RuntimeError("the f32 main path on the card disagrees with the CPU")
    z_max, z_med, agree, ok = compare("int8", "int8")
    c_max, c_med, _, _ = compare("none", "int8")
    print(f"[reference] int8 main path (f32 masters), card vs CPU plain: gen z max_abs_err "
          f"{z_max:.3e} (bound {Z_MAX_INT8}), median {z_med:.3e} (bound {Z_MEDIAN_INT8}), "
          f"tokens equal {agree:.4f} (printed, no limit), finite {ok}; control, the "
          f"unquantized path on the card: max {c_max:.3e}, median {c_med:.3e}", flush=True)
    if not (z_max <= Z_MAX_INT8 and z_med <= Z_MEDIAN_INT8 and ok):
        raise RuntimeError("the int8 main path on the card disagrees with the CPU")
    if c_max <= Z_MAX_INT8 or c_med <= Z_MEDIAN_INT8:
        raise RuntimeError("the int8 bounds do not tell the int8 path from the unquantized one")


def _http(port: int, method: str, path: str, payload=None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        body = None if payload is None else json.dumps(payload, default=lambda a: a.tolist())
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"{method} {path}: HTTP {resp.status} {data[:300]!r}")
    return json.loads(data)


def phase_http(engine, card: str) -> dict:
    """The shared HTTP front end over the int8 engine, dynamic batching
    pinned to bucket 64: concurrent responses must equal solo hetero calls."""
    from inpaintnet_tpu.server import InpaintingServer  # numpy only, no JAX
    from inpaintnet_tpu_torch.ops.distributions import row_bits

    keys = torch.from_numpy(np.random.default_rng(4).integers(0, 2**32, (64, 2)))
    if not torch.equal(row_bits(keys.cuda(), 100).cpu(), row_bits(keys, 100)):
        raise RuntimeError("per-row noise bits on the card differ from the CPU's")
    pin = 64
    engine.warmup(hetero=True)
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(16):
        m = int(rng.integers(4, N_BARS + 1))
        num = int(rng.integers(1, min(engine.max_target, m - 1) + 1))
        start = int(rng.integers(1, m - num + 1))
        reqs.append({"tokens": rng.integers(0, VOCAB, (int(rng.integers(1, 4)), m, 24)),
                     "start_measure": start, "num_measures": num, "seed": 1000 + i})
    server = InpaintingServer(engine, port=0, batching=True, pin_bucket=pin)
    port = server.start()
    try:
        results, errors = [None] * len(reqs), []

        def client(i):
            try:
                results[i] = np.asarray(_http(port, "POST", "/v1/inpaint", reqs[i])["tokens"])
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

        def drive():
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"HTTP clients failed: {errors[:3]}")
            return time.perf_counter() - t0

        wall, launches = _launches_during(_kernels_of("int8"), drive)
        batching = _http(port, "GET", "/healthz")
        for req, got in zip(reqs, results):
            want = engine.inpaint_hetero([req], bucket=pin)[0]
            if not np.array_equal(got, want):
                raise RuntimeError(f"HTTP response differs from the solo inpaint_hetero "
                                   f"(seed {req['seed']})")
        print(f"[http] {len(reqs)} concurrent /v1/inpaint: every response equals the solo "
              f"inpaint_hetero at bucket {pin}; {batching['batching']['calls']} coalesced "
              f"device calls; {wall * 1e3:.1f} ms wall; launches {launches} | {card}",
              flush=True)

        tokens = reqs[0]["tokens"]
        one = {"tokens": tokens, "start_measure": reqs[0]["start_measure"],
               "num_measures": reqs[0]["num_measures"], "seed": 77}
        var = np.asarray(_http(port, "POST", "/v1/inpaint_variations",
                               {**one, "num_variations": 3})["variations"])
        if var.shape != (3, *tokens.shape) or not np.array_equal(
                var[0], np.asarray(_http(port, "POST", "/v1/inpaint", one)["tokens"])):
            raise RuntimeError("variation 0 differs from the seeded /v1/inpaint")
        start, num = one["start_measure"], one["num_measures"]
        ticks = np.asarray(_http(port, "POST", "/v1/inpaint_ticks", {
            "tokens": tokens[0].reshape(-1), "start_tick": 24 * start,
            "end_tick": 24 * (start + num), "seed": 3})["tokens"])
        _check_response(ticks.reshape(1, -1, 24), tokens[:1], start, num)
        interp = np.asarray(_http(port, "POST", "/v1/interpolate", {
            "measure_a": tokens[0, 0], "measure_b": tokens[0, 1], "num_points": 6})["tokens"])
        if not np.array_equal(interp, engine.interpolate(tokens[0, 0], tokens[0, 1], 6)):
            raise RuntimeError("/v1/interpolate differs from the engine's interpolate")
        health = _http(port, "GET", "/healthz")
        if health["status"] != "ok" or ["hetero", pin] not in health["warmed"]:
            raise RuntimeError(f"/healthz: {health}")
        meta = _http(port, "GET", "/v1/meta")
        if meta["quant"] != "int8":
            raise RuntimeError(f"/v1/meta: {meta}")
        print(f"[http] variations (variation 0 == /v1/inpaint), ticks, interpolate, healthz "
              f"(warmed {len(health['warmed'])}), meta (quant {meta['quant']}): ok", flush=True)
    finally:
        server.stop()
    return launches


def main() -> int:
    card = phase_device()
    phase_build()
    from inpaintnet_tpu_torch.models.presets import build_flagship

    _, vae, model = build_flagship(seed=0, device="cuda", dtype=torch.float32)
    report = phase_kernels(vae, model.max_target, card)
    phase_reference(model)
    _, launches, span_bf16 = phase_engine(model, "bfloat16", card)
    engine8, launches8, span_int8 = phase_engine(model, "int8", card)
    print(f"[engine] int8 and bf16 agree on {(span_int8 == span_bf16).mean():.4f} of the "
          f"batch-{BATCH} span tokens (random weights: printed, no limit)", flush=True)
    launches_http = phase_http(engine8, card)
    sources = {
        "encoder_hn": ("encoder_gru.cu", "inpaintnet_tpu/ops/encoder_pallas.py:147", launches),
        "decode_sampling": ("decode_sampling.cu", "inpaintnet_tpu/ops/decode_pallas.py:216",
                            launches),
        "encoder_hn_int8": ("encoder_gru_int8.cu", "inpaintnet_tpu/ops/encoder_pallas.py:437",
                            launches8),
        "decode_sampling_int8": ("decode_sampling_int8.cu",
                                 "inpaintnet_tpu/ops/decode_pallas.py:451", launches8),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"inpaintnet_tpu_torch/ops/csrc/{src}", "replaces": replaces,
                "launches": runs[name], **report[name]}
               for name, (src, replaces, runs) in sources.items()]
    print(f"[launches] HTTP path: {launches_http}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
