#!/usr/bin/env python3
"""Drive the PyTorch port's serving (on its CUDA-graph route and its eager
one), training (MeasureVAE and LatentRNN), AnticipationRNN, evaluation,
command-line, data-parallel and tensor-parallel paths once on one NVIDIA
GPU.

    python3 chip_smoke.py [--parent DIR [--parent-only]] [--first-port DIR]

``--parent DIR`` names an earlier checkout of this repository (for example
``git archive`` of the parent commit, unpacked into a git-ignored
directory): the flagship's V 60 decode kernels (K2 and K4 at 12,288, 2,048
and 6 rows, K7 at 512, 64 and 1 rows, both dtypes) are timed through that
checkout's wrappers and this tree's, each in a process of its own
(``--kernel-times DIR``), in turns: parent, this, this, parent
(``[parent]`` lines). ``--first-port DIR`` names a checkout from before
the Hopper f32 routes: its K2 and K8 CUDA sources (``PARENT_SOURCES``) are
built too, and the K2 f32 and K8 f32 times are printed beside that
checkout's first kernels on the same card (otherwise "parent not
measured").

Phases, each raising on failure:

1. device: a CUDA card of compute capability 9.0 (Hopper); prints its name
   and power limit;
2. build: compiles the CUDA kernels (``inpaintnet_tpu_torch/ops/csrc``)
   with nvcc for sm_90a, one nvcc per source, in parallel;
3. each serving kernel against its plain PyTorch version on the card, at
   the shapes the engine gives them for a batch of 2048 requests: K1
   ``encoder_hn`` and K2 ``decode_sampling`` in f32 and bf16, K3
   ``encoder_hn_int8`` and K4 ``decode_sampling_int8`` on bf16 masters
   (bit-equal; each of their two traps, planted in the plain versions,
   must break that bound); in bf16 K1's share of changed h_n elements is
   bounded too, and a layer-1 input projection rounded to bf16, planted in
   the staged plain version, must break K1's bounds; in f32 two planted
   faults (the product on h taken as one bf16 piece, layer 1's projection
   rounded to bf16) must break K1's f32 bound; K1's function through
   cuDNN's ``torch.nn.GRU`` is timed beside it (the port never calls it);
   K1 in both dtypes and K3, whose Hopper routes run layer 0, a GEMM and
   layer 1 per chunk of rows, are timed with ``torch.profiler``'s split
   into those parts, their CUDA launches and peak memory, at 65,536 rows
   and at a batch-1 request's 32 (K1 f32 beside both its bounds, the split
   products' and the f32 FMA units', and the cost a per-chunk split of f32
   ys into the GEMM's pieces would add); K2 in both dtypes also at the
   autoregressive step's 2,048 rows and a batch-1 call's 6, every cluster
   size of its Hopper route against the plain version and bit-equal to the
   others, each timed beside its bound (f32: both bounds, the kernel's own
   device time and the parent's first kernel); K2 f32's planted faults at
   2,048 rows (the products on h as one bf16 piece and a reset tick on the
   previous tick's h must break ``BOUNDS``; layer 1's two products in one
   accumulator, on cancelling layer-1 biases, must move the mean logit
   error ``decode_kernel.SUM_ORDER_RATIO`` times the kernel's); with noise
   0.05 and 0.1 on the flagship decoder's weights at 2,048 rows, K2 bf16's
   mean and max logit error and early share against the plain version held
   to ``K2_NOISY``;
   K4 on bf16 and f32 masters at 12,288, 2,048 and 6 rows, every cluster
   size, bit-equal to its plain version and to each other, each timed
   beside its bound (``[plan]``: the launch plan);
4. the training kernels K5 ``gru_fwd_seq`` and K6 ``gru_bwd_seq`` against
   their plain versions at the VAE encoder's shape (24 steps, 4,096 rows,
   H 512, both directions), the beat GRU's (4 steps, 4,096 rows) and the
   tick GRU's (6 steps, 16,384 rows), in f32 and bf16; K6 at every cluster
   size of its Hopper route, bit-equal to the others, each timed beside
   both its bounds (the f32 FMA units', the split product's on the tensor
   cores); K5 likewise at every cluster size (bit-equal), timed beside its
   bound; a K5 carry rounded to bf16,
   (f32) a K5 product on h taken as one bf16 piece, a K6 product on bf16 dhw
   and (bf16) a K6 dh carried in bf16, planted in the plain versions, must
   break the bounds;
5. the serving main path on the card against the same model on the CPU
   (plain versions) on a small input, f32 masters: unquantized, and int8,
   whose bounds the unquantized path must fail;
6. the bf16 engine (flagship geometry, random weights from seed 0) serves
   three requests, checked; K1 and K2 must have launched;
7. the int8 engine serves the same three requests, checked; K3 and K4 must
   have launched; the share of span tokens on which int8 and bf16 agree is
   printed (random weights set no limit on it); its batch-2048 and batch-1
   calls are profiled (``[profile] engine int8``);
8. HTTP: ``inpaintnet_tpu_torch.server.InpaintingServer`` (the port's
   numpy-only front end) in front of the int8 engine, dynamic batching pinned
   to bucket 64: 16 concurrent clients' ``/v1/inpaint`` responses must
   equal the engine's solo ``inpaint_hetero``, variation 0 of
   ``/v1/inpaint_variations`` the seeded ``/v1/inpaint``, and
   ``/v1/inpaint_ticks``, ``/v1/interpolate`` and ``/healthz`` must answer;
   K3 and K4 must have launched;
9. a VAE train step on the card (K5/K6) against the same step on the CPU
   (plain versions), small geometry, f32, the same dropout masks and noise,
   for each teacher-forcing coin: loss, gradients and post-Adam parameters;
10. the full-width VAE trainer (vocab 60, embedding 10, GRUs of hidden 512,
   z 256, 256 windows x 16 bars = 4,096 measure rows a step) takes steps in
   f32 and in bf16 compute, both coin branches; K5 and K6 must launch 8
   times a teacher-forced step and 6 times a sampling one; the loss must be
   finite and the parameters must move; ms per step, measures per second
   and peak memory are printed, and ``torch.profiler``'s split of one step
   of each branch by kernel, with the device's idle share;
11. times: measures/s at batch 2048 (6 past / 4 target / 6 future) with
   the call's peak memory, and the p50/p90 of a batch-1 request for each
   engine, and each kernel beside its plain version and its bound;
12. the AnticipationRNN (flagship: 2 x 256 LSTMs, random weights from seed
   0): K7 ``arnn_sampled_decode`` against its plain version at the engine's
   batch-512 x 384-tick shapes in f32 and bf16, with planted faults (a force
   mask read one tick late and a context projection rounded to bf16; in
   bf16 a c carry kept in f32, in f32 the products on h taken as one bf16
   piece) that the bounds must reject; both Hopper routes at every cluster
   size at 512, 64 and 1 rows, bit-equal to the others, their CUDA
   launches (two a chunk) and their device times, each timed beside the
   first kernel (``csrc/arnn_decode.cu``, which runs the geometries the
   Hopper routes do not take; f32 also beside both its bounds); with
   noise on the flagship's weights, the Hopper route held to the first
   kernel's error and the two bf16 faults rejected; the ARNN path on the
   card against the CPU (f32, H 64); the bf16 ``ARNNServingEngine`` serving
   batch 512 x 16 bars with a
   4-measure span and a batch-1 request (K7 must launch), its
   span-measures/s, batch-1 p50/p90 and a profile of each; and
   ``/v1/arnn/inpaint`` through the HTTP server, argmax and sampled clients
   equal to the solo ``inpaint_hetero`` at bucket 64;
13. K8 ``gru_layer_stream`` (the generic GRU layer, which also serves the
   TPU's K9 and K10) against its plain version at the engine's batch-2048
   shapes (the context GRUs: 16 steps, H 512, suffix masks with all-zero
   rows, outputs on and off; the generation GRU: 6 steps, H 1024, target
   masks; the autoregressive step: 1 step, H 1024, at 2,048 rows and at
   one; the beat GRU's), f32 and bf16 (every cluster size of the bf16
   route, bit-equal to each other; the f32 route's one size a width, H /
   64 CTAs, bit-equal across two runs), forward and reverse, with planted
   faults (a mask read one step late; in bf16 a carry kept in f32; in f32
   the product on h as one bf16 piece, and a held row writing no pieces,
   on the reverse run) that the bounds must reject; each timed (bf16: at
   each cluster size; f32: beside both bounds, its own device time and the
   parent's first kernel) beside its plain version, its bound and cuDNN's
   one-direction ``torch.nn.GRU`` as a yardstick;
14. the bf16 LatentRNN engine under the ``"pallas"`` GRU route beside
   ``"xla"``: K8 launches per call (asserted), no eager GRU step under
   ``"pallas"``, the batch-2048 wall and the batch-1 p50 in turns, and a
   profile of each;
15. the autoregressive LatentRNN on the card against the CPU (f32, H 64,
   the same injected noise), under ``"pallas"``;
16. the autoregressive flagship engine (hidden 512, generation hidden
   1024), bf16, under ``"pallas"``: three requests checked, K1, K2 and K8
   launches per call asserted, measures/s at batch 2048, the batch-1 p50,
   a profile of each, K8's and K2's device time a call with their launch
   plans and with half and twice the plans' cluster sizes (``[plan]``), and
   an ``/v1/inpaint`` burst through the HTTP server whose responses must
   equal the solo ``inpaint_hetero``;
17. the flagship f32 engine under ``"pallas"`` (the path of K1's, K2's and
   K8's f32 routes): three requests checked, K1, K2 and K8 launches per
   call asserted, measures/s at batch 2048 (6/4/6), the batch-1 p50 and a
   profile of each;
18. LatentRNN training: a step on the card against the same step on the
   CPU (f32, H 64, the same parameters, split and noise) for the
   non-autoregressive model and the autoregressive one on each coin, two
   Adam steps each, K2's tokens equal; then the full-width trainer at
   ``train_inpaintnet.py``'s defaults (32 windows of 16 bars, every
   dropout 0.5), both modes, f32 and bf16 compute: K2, K5 and K6 launches
   a step asserted (K6 only for the autoregressive sampled branch's
   unmasked hidden-1024 generation GRU, which runs K5/K6; its masked
   teacher-forced twin keeps the eager loop), the frozen VAE bit-unchanged,
   a validation step's K1 and K2
   launches; ms a step, windows/s, valid target measures/s, peak memory
   and a profile of each branch;
19. AnticipationRNN training: the port's ``FolkDatasetNBars`` built from
   ``generate_corpus`` (200 tunes, 16 bars; windows, vocabulary, host
   seconds and whether the native tokenizer ran); a train step of each
   trainer on each coin on the card against the CPU (f32, H 64, 9 bars, the
   same parameters, masks and coin, two Adam steps each, the sampled
   branch's tokens equal); then both trainers at ``train_arnn_baseline.py``'s
   and ``train_arnn_reg.py``'s width (2 x 256 LSTMs, linear 256, dropout
   0.2, batch 32 of 16 bars) in f32 and bf16 compute on both coins: K7
   never launched by a train step and once by each validation batch, the
   loss finite, the parameters moving; ms a step, windows/s, target
   ticks/s, peak memory, a profile of each branch with its launches split
   by the constraint stack, the generation stack or loop, and the
   backward, and K7's device time in a validation batch; last,
   ``train_model`` for one epoch on a 4-tune corpus, resumed exactly by
   ``load_state`` on a fresh trainer;
20. the command line (``inpaintnet_tpu_torch/cli``), in-process through
   each entry point's ``main(argv)`` on the card: ``prepare_corpus synth``
   (16 tunes of 16 bars, the run's only cut) and ``stats``; the five
   trainers one epoch each at the shipped widths (the MeasureVAE, the
   LatentRNN and its past and future ablations, both ARNNs in batches of
   128), each test loss finite; the joint evaluation ``test_reconstruction
   --include_ablations past,future`` (batches of 32 test windows, the last
   one short): every row printed, K1, K2 and K7 launched, windows/s,
   device time by kernel and idle share; the same evaluation on the CPU
   (the plain versions) on the same checkpoints, splits and noise, each
   model's loss and argmax tokens held to ``CLI_REF``; the VAE tester over
   the test split; both generation scripts' MIDI decoded, K2 launched by
   the batch-1 ``generate``; ``run_server`` as a subprocess answering
   ``/healthz`` and ``/v1/inpaint``, then stopped.

21. the rest of the training surface: K1's training mode
   (``encoder_hn(keep=, rate=)``, dropout 0.5) at the VAE step's 4,096 rows
   x 24, H 512, in f32 and bf16 against its plain version within K1's
   bounds, in one chunk and in four, with the planted fault (the keep mask
   read at a chunk's local rows) rejected, timed beside K1 inference at the
   same rows, the encoder's default training forward (K5, four launches),
   and cuDNN's ``nn.GRU(..., dropout=0.5)`` in train mode (a yardstick); the
   VAE trainer under ``INPAINTNET_TRAIN_ENCODER_IMPL=pallas``: phase 9's step
   on the card against the CPU, then the full-width trainer in f32 and bf16
   (K1 once a step, K5/K6 only for the decoder, asserted), timed beside the
   default route in turns; ``SRDecoder``, ``SRDecoderNoInput`` and the
   multinomial ``HierarchicalDecoder`` decode, two Adam steps each on the card
   against the CPU at H 64 with the same draws; two gloo ranks sharing the
   card training the full-width VAE two steps against one process
   (``TRAIN_REF``), a world-1 NCCL step, and the bf16 engine on a mesh naming
   the card twice, bit-equal to the engine without one at batch 2048.
22. the mesh's "model" axis: two gloo ranks sharing the card at model=2
   (``parallel/dryrun.py``) against one process: the flagship MeasureVAE
   forward with ``shard_params``'s gate blocks gathered on use, in bf16 and
   f32 (K1 and K2, bit-equal), the flagship LatentRNN step (K5 and K2,
   parameters within ``TP_PARAM_ATOL``), the trainer matrix (K7 in the
   ARNNs' validation); each rank's launches equal one process's, its gate
   bytes half of the whole; the step's wall beside one process's.
23. the engines' CUDA-graph route (``inpaintnet_tpu_torch/graphs.py``, the
   default on the card, which every serving phase above runs) against
   their eager route (``graphs=False``) on one engine each: the flagship
   LatentRNN engines in bf16 on ``"xla"`` and ``"pallas"``, int8, f32 on
   ``"pallas"``, the autoregressive one on ``"pallas"`` and the bf16 one on
   a mesh naming the card twice, at buckets 1 (the mesh: 2), 8 and 2048,
   through ``inpaint``, ``inpaint_hetero``, ``inpaint_variations`` and
   ``interpolate``; the bf16 ARNN engine at buckets 1 and 512, argmax,
   sampled and a sampled ``inpaint_hetero`` with rows shorter than their
   bucket. Each call's replay gives the eager call's tokens bit for bit
   and launches each kernel wrapper as often; ``torch.profiler`` names the
   same hand-written kernels, as often, in one replay as in one eager
   call; ``graphs=True`` on a CPU engine and a planted host sync inside a
   capture raise. Per engine (not the mesh): the batch-2048 (ARNN: 512)
   wall and rate and the batch-1 p50 / p90 on both routes in turns, a
   profile of each route's batch-1 call and of the graph route's big one
   (device time, launches, idle share), the capture seconds a key and the
   memory the graphs hold.
24. the heads over wider vocabularies and heads: K2 (bf16, f32) and K4
   (bf16 and f32 masters) at V 97 and 256 on the flagship decoder (H 512,
   a head and token table of V drawn anew) at 12,288, 2,048 and 6 rows
   against their plain versions (``BOUNDS``; K4 bit-equal), one launch a
   call, timed beside V 60; K7 (bf16, f32) at V 90 and 256 on the flagship
   ARNN at 512, 64 and 1 rows x 384 ticks, bf16 at H = C = 512 with a
   256-wide head and both dtypes at a 1,024-wide head (``ARNN_WIDE``, the
   first kernel timed beside), within ``ARNN_HEAD_BOUNDS`` (at the wide
   geometries bf16's early share within the first kernel's), with two CUDA
   launches a chunk of rows and none of the first kernel in a trace,
   timed; for each head a maximum tied
   across a chunk border taken by its first index, and the planted fault
   that lets the later chunk win (``kernel_common.head_ties``) rejected;
   the LatentRNN flagship at V 256 on the card against the CPU, its bf16
   (``"xla"``) and int8 engines and the ARNN flagship's bf16 engine at V 90
   (against the CPU at H 64) on the graph route, each at its big batch and
   at batch 1: checked, launches counted, measures/s, p50 and the decode
   kernel's device ms;
25. the widths that run on zero units (a layer padded to whole 64-unit
   blocks, or in bf16 above 512 to an even number of them): first the
   entry points a user calls, the f32 model at VAE and LatentRNN H 100 on
   ``"xla"`` and ``"pallas"`` and the ARNN at H 48 with C 100, card
   against CPU, then the LatentRNN engine at H 100 (bf16, int8, bf16 and
   f32 on ``"pallas"``) and the ARNN engine at H 48 / C 100 (f32, bf16),
   each call on the eager route and the graph route, tokens and launches
   equal (launches counted from 0: K1-K4, K7 and K8 must launch); K1 (f32,
   bf16), K3, K2 (f32, bf16), K4 (both masters) at H 100 and 200 on random
   weights at 2,048 rows, K7 (both dtypes) at H = C = 100 and 200 and at H
   48 with C 100 (64 rows x 384 ticks), K8 at H 100 (both dtypes) and bf16
   576 and 704 (2,048 rows, 6 steps, target masks), each against its plain
   version at H (K3/K4 bit-equal) with one launch, the planted gate-major
   padding (``kernel_common.gate_padding``) rejected, and timed beside the
   same kernel on operands made at the padded width, its plain version,
   its bound and (K1, K8) cuDNN; K5 and K6 at H 100 and 1024, both dtypes,
   at the generation GRU's training calls (32 rows, 1 step) and at 2,048
   rows x 6 steps, called as the trainfast Function calls them (padded
   once, K6 on K5's padded residuals), likewise (at 1024 nothing is
   padded: K5 f32 on a
   cluster of 16, K6 on 8 CTAs of 128 units); one sampled training step of
   the autoregressive flagship with its H-1024 generation GRU on K5/K6
   (launches counted from 0: K5 8 and K6 4 a target step, no eager step of
   that width), beside the same step on the eager loop, in turns, each
   route's ms and traced device launches;
26. K1-K4 above 512 units in bf16 masters (K1 to H 577, K3 to 527 where
   the JAX package quantizes, K2/K4 to H 717): the LatentRNN engine over a
   VAE whose encoder is 577 wide (K1 at 640, on zero units; int8 runs K1
   there, unquantized as in the JAX package) and whose decoder is 640 wide,
   bf16 and int8,
   each call on the eager route and the graph route, tokens and launches
   equal (launches counted from 0: K1-K4 must launch); the entry points
   (``Encoder.apply`` at H 576, the decode at H 704, run at 768), bf16
   masters on the card against the CPU within ``BOUNDS``; K1 bf16 at H 576
   and 577 and K3 at 527 (run at 576) at 2,048 and 65,536 rows, K1's
   training mode at 576,
   K2 bf16 and K4 at H 576, 640, 704 and 717 at 2,048 and 12,288 rows and
   V 60 and 128, each against its plain version (K3/K4 bit-equal) with one
   launch, the planted gate-major padding rejected where the width runs
   on zero units, and timed beside the same kernel at the padded width,
   its plain version, its bound and (K1) cuDNN.
27. K7 at the JAX kernel gate's widest geometries: bf16 at (H, C) (576,
   256), (600, 64) and (619, 16) (run at 576 and 640 on clusters of 9 and
   10), at H 256 with C 1,024 and 3,954, f32 at H 256 with C 1,513; 512
   rows and 1 row, V 60 and 90, each within ``ARNN_BOUNDS`` (V 90:
   ``ARNN_HEAD_BOUNDS``) of its plain version, two CUDA launches a chunk,
   the planted c carry and context projection faults rejected, a tie across
   a head chunk at H 576 taken by its first index; the bf16 ARNN engine at
   H 576 / C 256 on both routes, buckets 1 and 8; a gradient through K8's
   ``"pallas"`` route equal to the eager loop's.
28. K8, K5 and K6 above 1,024 units, on tile groups that span clusters,
   and the LatentRNN of hidden 768 (over the flagship VAE, random weights
   from seed 0) whose generation GRU is 1,536 wide: K8 at 1,536 at the
   engine's generation call (2,048 rows x 6 steps), the autoregressive
   step and a batch-1 call, K5 / K6 at the sampled training step's 32 rows
   x 1 step and at 2,048 x 6, both dtypes, each against its plain version
   with one launch on the group route, timed beside its bound, its plain
   version, cuDNN's one-direction GRU and (K8) the eager loop's device
   time; K8 bf16's generation call also on one launch a step, bit-equal,
   timed; the exchange's two planted faults (the other parity buffer, one
   arrival short) rejected in all three, and a group grid past what the
   card holds at once refused by the cooperative launch; then, launch counts from 0, the 768 model's f32 main path on the
   card against the CPU, its engines (bf16 and f32 masters, and the
   autoregressive one in bf16) on ``"pallas"`` at batch 2,048 and 1 on
   both routes (the generation GRU's K8 launches at 1,536 asserted, no
   eager step of that width), and its autoregressive trainer at
   ``train_inpaintnet.py``'s defaults in f32 and bf16 compute, both coins
   (K5 / K6 launches a step asserted).

Phase 26 runs after phase 4, before any engine holds a CUDA graph's
memory pool, and phase 28 after it, its engines deleted at its end; phase
17 after phase 7; phases 12-16 after phase 8, then
phase 24 and phase 23, before the training phases; phases 18, 19, 20, 21,
22, 25 and 27 last. ``--parent DIR`` also runs ``ROUTE_CASES`` (K1 f32,
K5, K6 and K8 at H <= 1,024) through DIR's wrappers and this tree's, in
processes of their own (``--route-outputs DIR OUT``), in turns: bit-equal
outputs, times printed; and times the 768 LatentRNN's bf16 engine on
``"pallas"``, graph route, at batch 2,048 and 1 through DIR and this tree
(``--engine-times DIR``), in turns. ``--parent-only`` runs only those
comparisons and exits. ``--k7-sums`` runs only ``phase_k7_sums``: where K7's
bf16 early-logit share comes from (its context GEMM's partials and its
recurrence's sums, each against the plain version). Prints one
JSON line of the eight kernels (each with its launches in phase 18,
``latent_train_launches``, in phase 19, ``arnn_train_launches``, and in
phase 20's joint evaluation, ``eval_launches``, and in phase 23's graph
replays, ``graph_launches``; K1's with ``train_mode``,
phase 21's numbers of its training mode; K1's, K2's, K5's and K7's with
``tp_launches``, rank 0's in phase 22; K2's, K4's and K7's with
``vocab_heads``, phase 24's entries at the wider heads, and
``vocab_engine_launches``; every kernel's ``hidden_widths``, phase 25's
entries, and ``width_launches``, its main paths': K5's and K6's in its
training step, the others' in its engines at narrow widths; K1-K4's
``wide_widths``, phase 26's entries, and ``wide_launches``, their launches
in its engines' replays; K5's, K6's and K8's ``wide_layers``, phase 28's
entries, and ``wide_layer_launches``, their launches in its main paths),
the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits nonzero, printing no
result, when there is no usable card or any phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import http.client
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

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
# K1 bf16 h_n against its plain version: besides BOUNDS' max, at most this
# share of elements not bit-equal (gru_kernel.BOUNDS' rule: order flips
# stay a minority, a wrong rounding moves many elements a little). The
# planted fault, layer 1's input projection rounded to bf16 before the
# recurrence reads it, must break the max or the share. Seen on an H100
# (700 W) at the flagship's random weights: the kernel 4.9e-4 max on 9.8%
# of elements (2.8% of layer 0's, 16.8% of layer 1's: |h| averages 7.5e-3,
# so an f32 last bit flips many bf16 roundings of small values); the fault
# 2.4e-4 max, under the kernel's, on 21.4% (40.1% of layer 1's). The max
# alone cannot tell them apart; the share can.
ENCODER_SHARE_BF16 = 0.15
PLANTED_ROWS = 16384  # rows the plain version runs with the planted fault
# The int8 main path on the card against the CPU (f32 masters): gate ulps of
# the two devices' exp/tanh flip a few carry roundings, each of which moves
# one row's z. Seen on an H100 (700 W) at H 512: median 2.9e-5, max 9.6e-4;
# the unquantized path on the card against the CPU's int8 (the control,
# which must fail both bounds in every run): median 4.6e-4, max 3.8e-3. At
# H 372 (INT8_REF_HIDDEN): median 4.8e-8, max 3.5e-7; the control median
# 4.7e-4, max 4.0e-3 (NVIDIA H100 80GB HBM3, 700 W).
Z_MEDIAN_INT8, Z_MAX_INT8 = 1e-4, 2e-3
# The int8 check's model: f32 masters at the widest H whose encoder the JAX
# package quantizes (18 H^2 x 4 bytes < 10e6; its decode to H 499 at V 60).
# At the flagship's f32 H 512 the JAX package's kernel gates are closed and
# int8 computes unquantized there, in both packages.
INT8_REF_HIDDEN = 372
# K5/K6 against their plain versions on the card, as the (max, mean) over
# the outputs of |kernel - plain| / (1 + |plain|) (absolute below 1,
# relative above: the products' sums grow with H). f32: both accumulate in
# true f32, only the summation order differs (seen 1.0e-6 / 7.4e-8 at the
# encoder's shape, NVIDIA H100 80GB HBM3, 700 W). bf16: the outputs are
# stored in bf16, so an f32 last bit may flip one output's rounding (one
# ulp, 3.9e-3 of the value; 1e-2 allows two), and a flip in K5's bf16 copy
# of the carry moves that row's later products a little, so a row's flips
# cascade: seen max 2.6e-3, mean 1.1e-5 at the encoder's shape. The
# planted faults move every output a little and the mean catches them.
TRAIN_BOUNDS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 5e-5)}
# The full-width VAE step: 256 windows of 16 bars, K5/K6 launches a step by
# branch (teacher-forced: encoder 4 + beat GRU 2 + tick GRU 2; sampling:
# encoder 4 + beat GRU 2, the tick loop is eager).
TRAIN_WINDOWS = 256
TRAIN_LAUNCHES = {True: 8, False: 6}
# A train step on the card against the CPU, f32, the same masks and noise.
# Loss: the relative error of two f32 sums in another order (seen 1.2e-7 on
# an NVIDIA H100 80GB HBM3, 700 W). Gradients: |card - cpu| / (1 + |cpu|),
# sums over a few thousand terms in another order (seen 2.8e-9).
# Parameters after one or two Adam steps of lr 1e-3: an update is
# lr * m / (sqrt(v) + eps), so a gradient element that rounding noise
# dominates (its true value near 0) may move by up to lr on one device and
# not the other: the max allows two such steps (seen 2.0e-6), the mean that
# they are rare (seen 6.5e-10).
TRAIN_REF = {"loss": 1e-5, "grad": 1e-5, "param_max": 2e-3, "param_mean": 1e-6}
# The full-width LatentRNN trainer: train_inpaintnet.py's batch of 32
# windows of 16 bars (max context 16, max target 6).
LATENT_WINDOWS = 32
# AnticipationRNN training (phase 19): train_arnn_baseline.py's and
# train_arnn_reg.py's batch of 32 windows of 16 bars, on the port's
# FolkDatasetNBars over benchmarks/quality_check.py's 200-tune synthetic
# corpus (seed 7); train_model runs one epoch of a 4-tune corpus.
ARNN_WINDOWS = 32
ARNN_TUNES = 200
ARNN_SMALL_TUNES = 4
# Published dense peaks of an H100 SXM at 700 W (NVIDIA's data sheet):
# operations per second by product type, and device-memory bytes per second.
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


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


def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested dicts and lists too)."""
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def bound_of(ops: float, kind: str, moved: int) -> dict:
    """The least time the card could take: the larger of ``ops`` at the
    peak rate of their ``kind`` and ``moved`` bytes (each input read once,
    each output written once) at the memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS[kind] * 1e3, moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def encoder_ops(rows: int, steps: int, hidden: int) -> float:
    """Multiply-adds x 2 of the 2-layer bidirectional encoder per call: per
    step and direction, layer 0's recurrent (H, 3H) product (its input
    projection is a table row) and layer 1's recurrent and (2H, 3H) input
    products."""
    return 2.0 * steps * rows * 2 * (hidden * 3 * hidden + 3 * hidden * 3 * hidden)


def decode_ops(rows: int, hidden: int, vocab: int) -> float:
    """Multiply-adds x 2 of the 24-tick 2-layer decode per call: three
    (H, 3H) products and the (H, V) head per tick, and the per-beat
    context projection."""
    return 2.0 * rows * (24 * (3 * hidden * 3 * hidden + hidden * vocab)
                         + 4 * hidden * 3 * hidden)


# ---------------------------------------------------------------------------
# An earlier checkout's f32 routes of K2 and K8 (``--parent DIR``), timed
# beside the new ones in the same run
# ---------------------------------------------------------------------------
PARENT_SOURCES = ("decode_sampling.cu", "gru_layer.cu")


class ParentKernels:
    """The f32 routes of K2 and K8 as the checkout at ``root`` built them
    (its ``inpaintnet_tpu_torch/ops/csrc``; before this design, the first
    port's one-block-a-tile kernels with scalar-FMA products), called as
    that checkout's wrappers called them, the operands built on every call.
    Used only to time them beside the new routes on the same card in the
    same run."""

    def __init__(self, root: str):
        from inpaintnet_tpu_torch.ops.kernel_common import NVCC_FLAGS, _nvcc, _run_all

        csrc = Path(root) / "inpaintnet_tpu_torch" / "ops" / "csrc"
        out = Path(__file__).resolve().parent / "build" / "parent"
        out.mkdir(parents=True, exist_ok=True)
        objs = [str(out / f"{src}.o") for src in PARENT_SOURCES]
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(csrc / src)]
                  for src, obj in zip(PARENT_SOURCES, objs)], False)
        so = out / "libparent.so"
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so), *objs]], False)
        self.lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.lib.inpaint_decode_sampling_f32.argtypes = [ptr] * 13 + [i32] * 4 + [ptr]
        self.lib.inpaint_decode_sampling_f32.restype = i32
        self.lib.inpaint_gru_layer_f32.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        self.lib.inpaint_gru_layer_f32.restype = i32

    def decode_f32(self, dec, tick_ctx, h_inits):
        """The parent's K2 f32 route: the first port's kernel, one 16-row
        block a tile with scalar-FMA products, the weights as they are and
        the head padded to whole 8-column groups."""
        from inpaintnet_tpu_torch.ops.decode_kernel import NUM_TICKS, decode_inputs
        from inpaintnet_tpu_torch.ops.kernel_common import check_launch, stream_ptr

        p0, p1 = dec["tick_gru"][0][0], dec["tick_gru"][1][0]
        batch, _, hidden = tick_ctx.shape
        vocab = dec["head"]["w"].shape[1]
        pad = (0, -vocab % 8)
        head_w = torch.nn.functional.pad(dec["head"]["w"], pad).contiguous()
        head_b = torch.nn.functional.pad(dec["head"]["b"], pad).contiguous()
        bias = torch.stack([p0["b_hh"], p1["b_ih"], p1["b_hh"]])
        ins = decode_inputs(dec, tick_ctx, h_inits)
        logits = torch.empty((batch, NUM_TICKS, vocab), device=tick_ctx.device)
        samples = torch.empty((batch, NUM_TICKS), dtype=torch.int32, device=tick_ctx.device)
        check_launch(self.lib.inpaint_decode_sampling_f32(
            *(ins[k].data_ptr() for k in ("ctx_xw", "hi0", "hi1", "tok_tab", "x0_xw")),
            p0["w_hh"].data_ptr(), p1["w_ih"].data_ptr(), p1["w_hh"].data_ptr(),
            bias.data_ptr(), head_w.data_ptr(), head_b.data_ptr(), logits.data_ptr(),
            samples.data_ptr(), batch, hidden, vocab, head_w.shape[1], stream_ptr()),
            "the parent's decode_sampling f32")
        return logits, samples

    def gru_layer_f32(self, xw, w_hh, b_hh, h0, mask, want_ys):
        """The parent's K8 f32 route: the first port's kernel, one 16-row
        block a tile with scalar-FMA products."""
        from inpaintnet_tpu_torch.ops.kernel_common import check_launch, stream_ptr

        batch, steps, hidden = xw.shape[0], xw.shape[1], w_hh.shape[0]
        keep = None if mask is None else (mask > 0).to(torch.uint8).contiguous()
        ys = torch.empty((batch, steps, hidden), device=xw.device) if want_ys else None
        hn = torch.empty((batch, hidden), device=xw.device)
        check_launch(self.lib.inpaint_gru_layer_f32(
            xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
            None if keep is None else keep.data_ptr(), None if ys is None else ys.data_ptr(),
            hn.data_ptr(), batch, steps, hidden, 0, stream_ptr()), "the parent's gru_layer f32")
        return ys, hn


def parent_ms(parent, fn) -> str:
    """``fn(parent)`` timed, or "not measured" without ``--parent``."""
    return "not measured" if parent is None else f"{cuda_ms(lambda: fn(parent), 5):.3f} ms"


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


def phase_kernels(vae_f32, max_target: int, card: str, parent) -> dict:
    """Each kernel against its plain version at the engine's batch-2048
    shapes: K1/K2 in f32 and bf16, K3/K4 on bf16 masters (the int8 engine's);
    K2 bf16 also at the autoregressive step's and a batch-1 call's rows, and
    with noisy weights; K4 at those rows on both masters."""
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
    report, dec_inputs = {}, {}
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
        dec_inputs[label] = (dec, tick_ctx, h_inits)
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
        if label == "bfloat16":
            _check_encoder_share(gru, table, tokens, hn_k, hn_p)
        if label == "float32":
            _reject_encoder_f32_faults(gru, table, tokens, hn_k)
        library_ms = None
        if label != "int8":
            library_ms = cudnn_gru_ms(gru, table, tokens, hn_k, label, card)
        # times at these shapes (plain versions: few reps); the f32 routes
        # are printed only, not reported
        enc_name, dec_name = names or ("encoder_hn", "decode_sampling")
        kind = {"int8": "int8", "bfloat16": "bf16", "float32": "f32"}[label]
        H, V = gru[0][0]["w_hh"].shape[0], dec["head"]["w"].shape[1]
        if label != "int8":
            encoder_times(enc_k, gru, table, tokens, label, card)
        report[enc_name] = {"max_abs_err": hn_err,
                            "ms": cuda_ms(lambda: enc_k(gru, table, tokens), 5),
                            "plain_ms": cuda_ms(lambda: enc_p(gru, table, tokens), 2),
                            **bound_of(encoder_ops(enc_rows, 24, H), kind,
                                    nbytes(gru, table, tokens, hn_k)),
                            "library_ms": library_ms}
        dec_used = {k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")}
        report[dec_name] = {"max_abs_err": lg_err,
                            "ms": cuda_ms(lambda: dec_k(dec, tick_ctx, h_inits), 5),
                            "plain_ms": cuda_ms(lambda: dec_p(dec, tick_ctx, h_inits), 2),
                            **bound_of(decode_ops(dec_rows, H, V), kind,
                                    nbytes(dec_used, tick_ctx, h_inits, lg_k, s_k)),
                            "library_ms": None}
        if label == "float32":  # the split products' bounds, beside the f32 FMA units'
            fma = report[enc_name]
            report[enc_name] = {**fma, **bound_of(6 * encoder_ops(enc_rows, 24, H), "bf16",
                                                  nbytes(gru, table, tokens, hn_k)),
                                "bound_f32_fma_ms": fma["bound_ms"]}
            fma = report[dec_name]
            report[dec_name] = {**fma, **bound_of(6 * decode_ops(dec_rows, H, V), "bf16",
                                                  nbytes(dec_used, tick_ctx, h_inits, lg_k, s_k)),
                                "bound_f32_fma_ms": fma["bound_ms"]}
        for k in (enc_name, dec_name):
            v = report[k]
            fma = ""
            if "bound_f32_fma_ms" in v:
                fma = f", f32 FMA bound {v['bound_f32_fma_ms']:.3f} ms"
                fma += (f", cuDNN {v['library_ms']:.3f} ms" if k == enc_name else
                        f", the parent's f32 kernel "
                        f"{parent_ms(parent, lambda pk: pk.decode_f32(dec, tick_ctx, h_inits))}")
            print(f"[time] {k} {label}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, "
                  f"bound {v['bound_ms']:.3f} ms ({v['bound_by']}){fma} | {card}", flush=True)
        if names is None:  # the f32 routes' entries go beside the report's bf16 ones
            f32_report = {enc_name: report.pop(enc_name), dec_name: report.pop(dec_name)}
            _split_alternative(gru, table, tokens, card)
            decode_f32_row_counts(dec, tick_ctx, h_inits, card, parent)
            continue
        if label == "bfloat16":
            decode_row_counts(dec, tick_ctx, h_inits, bound, card)
            k2_noisy(dec, tick_ctx, h_inits, card)
    # K4 on the int8 engine's bf16 masters and on f32 masters (the card-vs-CPU
    # check's), the f32 case's decoder inputs
    decode_int8_row_counts({"bfloat16": dec_inputs["int8"], "float32": dec_inputs["float32"]},
                           card)
    report["encoder_hn"]["f32"] = f32_report["encoder_hn"]
    report["decode_sampling"]["f32"] = f32_report["decode_sampling"]
    return report


@contextlib.contextmanager
def _cluster(module, cluster, plan: str = "launch_plan"):
    """``module.<plan>`` (K8's or K2's ``launch_plan``, K4's ``int8_plan``)
    picks ``cluster`` CTAs a tile inside, its ring depth unchanged (None: the
    plan's own choice)."""
    from inpaintnet_tpu_torch.ops.kernel_common import LaunchPlan

    chosen = getattr(module, plan)
    if cluster is not None:
        setattr(module, plan, lambda *shape: LaunchPlan(cluster, chosen(*shape).stages))
    try:
        yield
    finally:
        setattr(module, plan, chosen)


# K2's rows: a batch-2048 call (max_target 6 a request), an autoregressive
# step at batch 2048 (one measure a request), a batch-1 call
DECODE_ROWS = (BATCH * 6, BATCH, 6)


@contextlib.contextmanager
def _f32_decode_cluster(cluster):
    """K2's f32 plan picks ``cluster`` CTAs a tile inside, with that size's
    ring depth (None: the plan's own choice)."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops.kernel_common import LaunchPlan

    chosen = dk.f32_plan
    if cluster is not None:
        dk.f32_plan = lambda rows, hidden, sms, slots=None: LaunchPlan(
            cluster, dk.f32_stages(hidden, cluster))
    try:
        yield
    finally:
        dk.f32_plan = chosen


def _reject_decode_f32_faults(dec, tc, hi, got, card: str) -> None:
    """K2 f32's planted faults against the kernel's output ``got``: the
    products on h as one bf16 piece and a reset tick's products on the
    previous tick's h must break ``BOUNDS[float32]``; layer 1's two products
    in one accumulator, on cancelling biases, must move the mean logit error
    ``SUM_ORDER_RATIO`` times the kernel's."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops.kernel_common import split_bf16_pieces

    b = BOUNDS[torch.float32]
    for hook, fault, name in (
            ("tick_product", lambda h, w: split_bf16_pieces(h)[0].float() @ w,
             "products on h as one bf16 piece"),
            ("beat_operand", lambda init, prev: prev, "a reset read from the previous tick")):
        real = getattr(dk, hook)
        setattr(dk, hook, fault)
        try:
            agree = dk.agreement(got, dk.decode_sampling_reference(dec, tc, hi))
        finally:
            setattr(dk, hook, real)
        print(f"[kernels] decode_sampling float32 planted fault, {name}: {agree}", flush=True)
        if dk.within(agree, b):
            raise RuntimeError(f"a planted K2 f32 fault passes the bounds: {name}")
    shifted = dk.cancelling_layer1_biases(dec, dk.SUM_ORDER_SHIFT)
    plain = dk.decode_sampling_reference(shifted, tc, hi)
    kernel = dk.agreement(dk.decode_sampling(shifted, tc, hi), plain)
    real = dk.layer1_preacts
    dk.layer1_preacts = dk.one_accumulator_preacts
    try:
        fault = dk.agreement(dk.decode_sampling_reference(shifted, tc, hi), plain)
    finally:
        dk.layer1_preacts = real
    print(f"[kernels] decode_sampling float32 on layer-1 biases +-{dk.SUM_ORDER_SHIFT:g}: kernel "
          f"{kernel}; planted fault, the two products in one accumulator: {fault} | {card}",
          flush=True)
    if fault["mean"] <= dk.SUM_ORDER_RATIO * kernel["mean"]:
        raise RuntimeError("K2 f32's sum-order fault is not told from the kernel")


def decode_f32_row_counts(dec, tick_ctx, h_inits, card: str, parent) -> None:
    """K2 f32 at ``DECODE_ROWS``: every cluster size of its route against
    the plain version (``BOUNDS[float32]``) and bit-equal to the others,
    each timed beside both bounds (the f32 FMA units', the split passes' on
    the tensor cores), the kernel's own device time and the parent's first
    kernel; the planted faults at 2,048 rows."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk

    hidden, vocab = tick_ctx.shape[2], dec["head"]["w"].shape[1]
    b = BOUNDS[torch.float32]
    for rows in DECODE_ROWS:
        tc, hi = tick_ctx[:rows].contiguous(), h_inits[:, :rows].contiguous()
        plan = dk.f32_card_plan(rows, hidden, tc.device)
        outs, ms = {}, {}
        for c in dk.f32_cluster_sizes(hidden):
            with _f32_decode_cluster(c):
                outs[c] = dk.decode_sampling(dec, tc, hi)
                ms[c] = cuda_ms(lambda: dk.decode_sampling(dec, tc, hi), 5)
        got = outs[plan.cluster]
        agree = dk.agreement(got, dk.decode_sampling_reference(dec, tc, hi))
        same = all(torch.equal(o[0], got[0]) and torch.equal(o[1], got[1]) for o in outs.values())
        print(f"[kernels] decode_sampling float32 rows {rows}: {agree}; clusters "
              f"{sorted(outs)} bit-equal {same} (bounds {b})", flush=True)
        if not (same and dk.within(agree, b) and bool(torch.isfinite(got[0]).all())):
            raise RuntimeError(f"K2 f32 at {rows} rows disagrees with its plain version or "
                               "across cluster sizes")
        if rows == BATCH:
            _reject_decode_f32_faults(dec, tc, hi, got, card)
        moved = nbytes({k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")}, tc, hi,
                       *got)
        fma = bound_of(decode_ops(rows, hidden, vocab), "f32", moved)
        split = bound_of(6 * decode_ops(rows, hidden, vocab), "bf16", moved)
        alone = _device_ms(lambda: dk.decode_sampling(dec, tc, hi), "decode_f32_kernel")
        plain_ms = cuda_ms(lambda: dk.decode_sampling_reference(dec, tc, hi), 2)
        per = ", ".join(f"cluster {c} {v:.3f} ms" for c, v in ms.items())
        print(f"[plan] decode_sampling float32 rows {rows}: cluster {plan.cluster}, stages "
              f"{plan.stages}; slots {dk.f32_slots(hidden, tc.device.index or 0)} | {card}",
              flush=True)
        print(f"[time] decode_sampling float32 rows {rows}: kernel {ms[plan.cluster]:.3f} ms "
              f"({per}); the kernel alone {alone:.3f} ms device; plain {plain_ms:.3f} ms; "
              f"bound {split['bound_ms']:.4f} ms (the split passes, {split['bound_by']}), f32 "
              f"FMA bound {fma['bound_ms']:.4f} ms; the parent's f32 kernel "
              f"{parent_ms(parent, lambda pk: pk.decode_f32(dec, tc, hi))}; 1 launch a call "
              f"| {card}", flush=True)


def decode_row_counts(dec, tick_ctx, h_inits, bound, card: str) -> None:
    """K2 bf16 at ``DECODE_ROWS``: every cluster size against the plain
    version (``BOUNDS``) and bit-equal to the others (the cluster only moves
    h between CTAs), each timed beside the bound and the kernel's own device
    time."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops.kernel_common import cluster_sizes

    hidden, vocab = tick_ctx.shape[2], dec["head"]["w"].shape[1]
    for rows in DECODE_ROWS:
        tc, hi = tick_ctx[:rows].contiguous(), h_inits[:, :rows].contiguous()
        plan = dk.card_plan(rows, hidden, tc.device)
        outs, ms = {}, {}
        for c in cluster_sizes(hidden):
            with _cluster(dk, c):
                outs[c] = dk.decode_sampling(dec, tc, hi)
                ms[c] = cuda_ms(lambda: dk.decode_sampling(dec, tc, hi), 5)
        lg_p, s_p = dk.decode_sampling_reference(dec, tc, hi)
        lg_k, s_k = outs[plan.cluster]
        agree = (s_k == s_p).float().mean().item()
        lg_err = (lg_k.float() - lg_p.float()).abs()[_first_divergence_mask(s_k, s_p)].max().item()
        same = all(torch.equal(o[0], lg_k) and torch.equal(o[1], s_k) for o in outs.values())
        print(f"[kernels] decode_sampling bfloat16 rows {rows}: tokens equal {agree:.6f}, logits "
              f"max_abs_err {lg_err:.3e}; clusters {sorted(outs)} bit-equal {same}", flush=True)
        if not (same and agree >= bound["tokens"] and lg_err <= bound["logits"]):
            raise RuntimeError(f"K2 bf16 at {rows} rows disagrees with its plain version or "
                               "across cluster sizes")
        b = bound_of(decode_ops(rows, hidden, vocab), "bf16",
                     nbytes({k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")},
                            tc, hi, lg_k, s_k))
        per = ", ".join(f"cluster {c} {v:.3f} ms" for c, v in ms.items())
        alone = _device_ms(lambda: dk.decode_sampling(dec, tc, hi), "rec90::decode_kernel<")
        print(f"[plan] decode_sampling bfloat16 rows {rows}: cluster {plan.cluster}, stages "
              f"{plan.stages} | {card}", flush=True)
        print(f"[time] decode_sampling bfloat16 rows {rows}: kernel {ms[plan.cluster]:.3f} ms "
              f"(cluster {plan.cluster}, stages {plan.stages}; {per}); the kernel alone "
              f"{alone:.3f} ms device; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); 1 launch a call | {card}", flush=True)


# K2 bf16 with noise of these scales added to the flagship decoder's weights
# (their logits then spread, and order flips of bf16 roundings show) at
# 2,048 rows, against the plain version (``arnn_kernel.decode_agreement``,
# the early share over the first beat's 6 ticks): the logits' mean and max
# where the fed-back tokens agree, and the share of early logits changed,
# at most these. The mean and the early share lie between the readings of
# the kernel that sums layer 1 as the plain version does and of the one that
# summed its r/z products in one accumulator over K = 2H, ((x + h) + b_ih1)
# + b_hh1, on an NVIDIA H100 80GB HBM3 (700 W): noise 0.05, mean 3.291e-5
# against 3.422e-5, early 0.0194 against 0.0207; noise 0.1, 1.098e-4
# against 1.208e-4, 0.0261 against 0.0297; the max is one bf16 ulp of the
# largest logits in both (PERF.md).
K2_NOISE = (0.05, 0.1)
K2_NOISY = {0.05: {"mean": 3.36e-5, "max": 1.5625e-2, "early": 0.0200},
            0.1: {"mean": 1.15e-4, "max": 3.125e-2, "early": 0.0280}}
K2_NOISY_ROWS = 2048


def k2_noisy(dec, tick_ctx, h_inits, card: str) -> None:
    """K2 bf16 with noisy weights (``K2_NOISE``) at ``K2_NOISY_ROWS`` rows
    against its plain version."""
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak
    from inpaintnet_tpu_torch.ops import decode_kernel as dk

    rows = K2_NOISY_ROWS
    tc, hi = tick_ctx[:rows].contiguous(), h_inits[:, :rows].contiguous()
    used = {k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")}
    gen = torch.Generator(device="cuda").manual_seed(11)
    unforced = torch.zeros((rows, 24), dtype=torch.int32, device=tc.device)
    for noise in K2_NOISE:
        p = {**dec, **_noisy(used, noise, gen)}
        want = dk.decode_sampling_reference(p, tc, hi)
        got = ak.decode_agreement(dk.decode_sampling(p, tc, hi), want, unforced, early_ticks=6)
        b = K2_NOISY[noise]
        print(f"[kernels] decode_sampling bfloat16 noise {noise}, {rows} rows: kernel "
              f"{_agreement_line(got)} (bounds {b}) | {card}", flush=True)
        if not (got["logits_mean"] <= b["mean"] and got["logits_max"] <= b["max"]
                and got["early_changed"] <= b["early"]):
            raise RuntimeError(f"K2 bf16 drifts from its plain version at noise {noise}")
    # the card test's inputs (test_decode_kernel_bf16_noisy_layer1_sum_order),
    # whose bound lies between these two readings
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda_kernels import K2_NOISY_BOUNDS, _decode_case

    params, tc, hi = _decode_case(np.random.default_rng(91), 512, 512, 60, torch.bfloat16,
                                  tick_ctx.device)
    want = dk.decode_sampling_reference(params, tc, hi)
    unforced = unforced[:512]
    got = ak.decode_agreement(dk.decode_sampling(params, tc, hi), want, unforced, early_ticks=6)
    print(f"[kernels] decode_sampling bfloat16, the card test's inputs (512 rows, noise 0.1): "
          f"kernel {_agreement_line(got)} (the test's bounds {K2_NOISY_BOUNDS}) | {card}",
          flush=True)


def decode_int8_row_counts(inputs: dict, card: str) -> None:
    """K4 at ``DECODE_ROWS`` on each master dtype's decoder inputs
    ({dtype label: (decoder params, tick_ctx, h_inits)}): every cluster size
    bit-equal to the plain version and so to the others, each timed beside
    the bound and the kernel's own device time."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops.kernel_common import cluster_sizes

    for label, (dec, tick_ctx, h_inits) in inputs.items():
        hidden, vocab = tick_ctx.shape[2], dec["head"]["w"].shape[1]
        used = {k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")}
        for rows in DECODE_ROWS:
            tc, hi = tick_ctx[:rows].contiguous(), h_inits[:, :rows].contiguous()
            plan = dk.int8_plan(hidden)
            want = dk.decode_sampling_int8_reference(dec, tc, hi)
            equal, ms = {}, {}
            for c in cluster_sizes(hidden):
                with _cluster(dk, c, "int8_plan"):
                    lg, smp = dk.decode_sampling_int8(dec, tc, hi)
                    equal[c] = bool(torch.equal(lg, want[0]) and torch.equal(smp, want[1]))
                    ms[c] = cuda_ms(lambda: dk.decode_sampling_int8(dec, tc, hi), 5)
            print(f"[kernels] decode_sampling_int8 {label} masters rows {rows}: bit-equal to the "
                  f"plain version at clusters {equal}", flush=True)
            if not all(equal.values()):
                raise RuntimeError(f"K4 on {label} masters at {rows} rows is not bit-equal to its "
                                   "plain version at every cluster size")
            b = bound_of(decode_ops(rows, hidden, vocab), "int8", nbytes(used, tc, hi, *want))
            per = ", ".join(f"cluster {c} {v:.3f} ms" for c, v in ms.items())
            alone = _device_ms(lambda: dk.decode_sampling_int8(dec, tc, hi), "decode_i8_kernel<")
            print(f"[plan] decode_sampling_int8 {label} rows {rows}: cluster {plan.cluster}, "
                  f"stages {plan.stages} | {card}", flush=True)
            print(f"[time] decode_sampling_int8 {label} masters rows {rows}: kernel "
                  f"{ms[plan.cluster]:.3f} ms (cluster {plan.cluster}, stages {plan.stages}; "
                  f"{per}); the kernel alone {alone:.3f} ms device; bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); 1 launch a call | {card}",
                  flush=True)


def _check_encoder_share(gru, table, tokens, hn_k, hn_p) -> None:
    """K1 bf16: the share of h_n elements that differ from the plain
    version must stay under ``ENCODER_SHARE_BF16``, and the planted fault
    (layer 1's input projection rounded to bf16, in the staged plain
    version, on the first ``PLANTED_ROWS`` rows) must break the max bound or
    that share."""
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek

    share = (hn_k != hn_p).float().mean().item()
    exact = ek.input_projection_reference
    ek.input_projection_reference = lambda ys, w, b: exact(ys, w, b).bfloat16().float()
    try:
        planted = ek.encoder_hn_staged_reference(gru, table, tokens[:PLANTED_ROWS])
    finally:
        ek.input_projection_reference = exact
    torch.cuda.synchronize()
    got = hn_k[:, :PLANTED_ROWS]
    p_err = (got.float() - planted.float()).abs().max().item()
    p_share = (got != planted).float().mean().item()
    del planted
    torch.cuda.empty_cache()
    print(f"[kernels] bfloat16: encoder_hn h_n not bit-equal to its plain version on "
          f"{share:.6f} of elements (bound {ENCODER_SHARE_BF16}); planted bf16 xw1 on "
          f"{PLANTED_ROWS} rows: max_abs_err {p_err:.3e}, share {p_share:.6f}", flush=True)
    if share > ENCODER_SHARE_BF16:
        raise RuntimeError("encoder_hn bf16 changes too many elements against its plain version")
    if p_err <= BOUNDS[torch.bfloat16]["hn"] and p_share <= ENCODER_SHARE_BF16:
        raise RuntimeError("the planted bf16 xw1 passes the encoder's bf16 bounds")


def _reject_encoder_f32_faults(gru, table, tokens, hn_k) -> None:
    """K1 f32's planted faults, in its plain versions on the first
    ``PLANTED_ROWS`` rows, must break ``BOUNDS[float32]`` against the kernel:
    the recurrent product on h taken as one bf16 piece, and layer 1's
    projection rounded to bf16 (the staged plain version)."""
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek

    tk = tokens[:PLANTED_ROWS]
    product, exact = ek.recurrent_product, ek.input_projection_reference
    faults = {}
    ek.recurrent_product = lambda h, w: h.bfloat16().float() @ w
    try:
        faults["product on h as one bf16 piece"] = ek.encoder_hn_reference(gru, table, tk)
    finally:
        ek.recurrent_product = product
    ek.input_projection_reference = lambda ys, w, b: exact(ys, w, b).bfloat16().float()
    try:
        faults["layer 1's projection rounded to bf16"] = ek.encoder_hn_staged_reference(
            gru, table, tk)
    finally:
        ek.input_projection_reference = exact
    torch.cuda.synchronize()
    for name, planted in faults.items():
        err = (hn_k[:, :PLANTED_ROWS] - planted).abs().max().item()
        print(f"[kernels] float32 planted fault, {name}, {PLANTED_ROWS} rows: encoder_hn h_n "
              f"max_abs_err {err:.3e} (bound {BOUNDS[torch.float32]['hn']:.1e})", flush=True)
        if err <= BOUNDS[torch.float32]["hn"]:
            raise RuntimeError(f"a planted K1 f32 fault passes the f32 bound: {name}")


def _split_alternative(gru, table, tokens, card: str) -> None:
    """K1 f32's layer 0 writes its outputs as the GEMM's three bf16 pieces.
    The other way, layer 0 writing f32 ys and a per-chunk split into the
    pieces, would add that split: timed here on one chunk's f32 ys (through
    ``split_bf16_pieces``' PyTorch ops), beside layer 0's own device time a
    chunk."""
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops.kernel_common import split_bf16_pieces

    H = gru[0][0]["w_hh"].shape[0]
    chunk = ek.encoder_chunk_rows(tokens.shape[0], 24, H, dtype=torch.float32)
    ys = torch.rand((24 * chunk, 2 * H), device=tokens.device)
    ms = cuda_ms(lambda: torch.stack(split_bf16_pieces(ys)), 5)
    print(f"[time] encoder_hn float32: a per-chunk split of f32 ys ({24 * chunk} x {2 * H}) "
          f"into three bf16 pieces would add {ms:.3f} ms a chunk, "
          f"{ms * -(-tokens.shape[0] // chunk):.3f} ms a call | {card}", flush=True)


# The Hopper route's three kernels, as torch.profiler names them (mangled
# or not): layer 0's and layer 1's recurrence and the projection GEMM; in
# f32 K5's recurrence in its K1 modes and the split GEMM.
ENCODER_PARTS = (("layer 0", "encoder_rec_kernel", ("true>", "Lb1E")),
                 ("GEMM", "encoder_xw_gemm_kernel", ()),
                 ("layer 1", "encoder_rec_kernel", ("false>", "Lb0E")))
ENCODER_F32_PARTS = (("layer 0", "gru_fwd_kernel", ("<float, 1, 1", "Li1ELi1E")),
                     ("GEMM", "encoder_xw_gemm_split_kernel", ()),
                     ("layer 1", "gru_fwd_kernel", ("<float, 1, 2", "Li1ELi2E")))


def encoder_parts(call, want: int, kinds=ENCODER_PARTS) -> tuple:
    """``torch.profiler``'s split of one encoder call: ({part: device ms},
    CUDA launches of the three kernels, device ms of every other kernel:
    the wrapper's operand preparation), traced again while fewer than
    ``want`` launches show."""
    def count(trace):
        parts, launches, other = {label: 0.0 for label, _, _ in kinds}, 0, 0.0
        for name, ms, n in trace[2]:
            for label, kernel, flags in kinds:
                if kernel in name and (not flags or any(f in name for f in flags)):
                    parts[label] += ms
                    launches += n
                    break
            else:
                other += ms
        return parts, launches, other
    return _profile_retaken(count, call, want)


def encoder_times(enc_k, gru, table, tokens, label: str, card: str) -> None:
    """The Hopper route at the engine's batch-2048 shape and at a batch-1
    request's (32 rows): the wrapper's time, its parts' device times, its
    CUDA launches (which must be three a chunk) and its peak device memory."""
    from inpaintnet_tpu_torch.ops.encoder_kernel import encoder_cuda_launches

    H = gru[0][0]["w_hh"].shape[0]
    kinds = ENCODER_F32_PARTS if table.dtype == torch.float32 else ENCODER_PARTS
    for rows in (tokens.shape[0], 2 * N_BARS):
        tk = tokens[:rows].contiguous()
        ms = cuda_ms(lambda: enc_k(gru, table, tk), 5)
        want = encoder_cuda_launches(table.dtype, rows, 24, H)
        parts, launches, other = encoder_parts(lambda: enc_k(gru, table, tk), want, kinds)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        enc_k(gru, table, tk)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        split = ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        print(f"[time] {enc_k.__name__} {label} rows {rows}: {ms:.3f} ms a call; device: {split}, "
              f"operand preparation {other:.3f} ms; {launches} CUDA launches of the three "
              f"kernels ({want} expected); peak {peak:.2f} GiB above the {base / 2**30:.2f} GiB "
              f"held | {card}", flush=True)
        if launches != want:
            raise RuntimeError(f"{enc_k.__name__}: {launches} CUDA launches, expected {want}")


def cudnn_gru_ms(gru, table, tokens, hn_k, label: str, card: str) -> float:
    """K1's function through one PyTorch call, timed as a yardstick only
    (the port never calls it): cuDNN's ``torch.nn.GRU(E, H, 2,
    bidirectional=True)`` holding the same weights, over the embedded
    tokens, returns the same h_n. In f32 (no TF32) it must agree with K1."""
    hidden, emb = gru[0][0]["w_hh"].shape[0], table.shape[1]
    net = torch.nn.GRU(emb, hidden, 2, batch_first=True, bidirectional=True).to(
        device=tokens.device, dtype=table.dtype).eval()
    with torch.no_grad():
        for layer in range(2):
            for d in range(2):
                sfx, p = f"_l{layer}" + ("_reverse" if d else ""), gru[layer][d]
                for name, w in (("weight_ih", p["w_ih"].t()), ("weight_hh", p["w_hh"].t()),
                                ("bias_ih", p["b_ih"]), ("bias_hh", p["b_hh"])):
                    getattr(net, name + sfx).copy_(w)
        net.flatten_parameters()  # one contiguous weight buffer, as cuDNN wants it
        x = table[tokens.long()]
        err = (net(x)[1].float() - hn_k.float()).abs().max().item()
        ms = cuda_ms(lambda: net(x), 3)
    print(f"[time] encoder_hn {label}: cuDNN torch.nn.GRU {ms:.3f} ms (h_n max_abs_err against "
          f"K1 {err:.3e}) | {card}", flush=True)
    if label == "float32" and err > 1e-4:
        raise RuntimeError("cuDNN's GRU is not K1's function: the yardstick would be wrong")
    return ms


def _train_kernel_case(seed: int, batch: int, steps: int, hidden: int, dtype, zero_h0: bool):
    """K5's inputs made on the card from a seed (xw at the scale of a layer
    input's projection, W_hh at Xavier's), and K6's cotangents."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(dtype)

    w_hh = randn(hidden, 3 * hidden, scale=(2.0 / (4 * hidden)) ** 0.5)
    fwd = (w_hh, randn(3 * hidden, scale=0.1), randn(batch, steps, 3 * hidden, scale=0.5),
           randn(batch, hidden, scale=0.0 if zero_h0 else 0.5))
    return fwd, randn(steps, batch, hidden)


def _train_kernel_errs(got, want):
    """(max, mean) of |got - plain| / (1 + |plain|) over the outputs, and
    the plain max absolute error."""
    d = [(a.float() - b.float()).abs() for a, b in zip(got, want)]
    rel = [x / (1.0 + b.float().abs()) for x, b in zip(d, want)]
    return (max(x.max().item() for x in rel), max(x.mean().item() for x in rel),
            max(x.max().item() for x in d))


def _run_k5_k6(fwd, dys, reverse: bool, gk):
    """K5, then K6 on K5's gates with h_{t-1} built as the autograd
    Function builds it. -> (K5 outputs, K6 outputs, h_{t-1})."""
    out = gk.gru_fwd_seq(*fwd, reverse=reverse)
    ys, h0 = out[0], fwd[3]
    hprev = torch.cat([ys[1:], h0[None]]) if reverse else torch.cat([h0[None], ys[:-1]])
    return out, gk.gru_bwd_seq(fwd[0], dys, *out[1:], hprev, reverse=reverse), hprev


def _k5_k6_bounds(steps: int, batch: int, hidden: int, dtype, fwd, out, grads, dys, hprev):
    """K5's and K6's bounds at these shapes. K5: the (H, 3H) recurrent
    product per step and row, at the product type's rate (bf16 tensor cores,
    or f32); bytes: xw, h0, W_hh, b_hh in, five (steps, B, H) out. K6: the
    (3H, H) product per step and row, an f32 product in every dtype, which
    on the tensor cores is 3 bf16 passes over dhw's pieces (bf16 W) or 6
    (f32 W split too): its bound, with the f32 FMA units' as
    ``bound_f32_fma_ms``; bytes: six (steps, B, H) in, da and dhw (steps, B,
    3H) and dh0 out."""
    ops = 2.0 * steps * batch * hidden * 3 * hidden
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    moved = nbytes(fwd[0], dys, out[1:], hprev, grads)
    passes = 3 if dtype == torch.bfloat16 else 6
    return (bound_of(ops, kind, nbytes(fwd, out)),
            {**bound_of(passes * ops, "bf16", moved),
             "bound_f32_fma_ms": bound_of(ops, "f32", moved)["bound_ms"]})


def _reject_train_faults(fwd, dys, out_k, grads_k, hprev, dtype, gk):
    """A K5 carry rounded to bf16 every step, (f32) a K5 product on h taken
    as one bf16 piece, a K6 product on dhw rounded to bf16 and (bf16) a K6 dh
    carried in bf16 between steps, planted in the plain versions, must break
    the bounds. (In bf16 the one-piece product and the f32 dh are the
    function itself.)"""
    carry, fwd_product = gk.fwd_carry, gk.fwd_product
    product, bwd_carry = gk.bwd_product, gk.bwd_carry
    gk.fwd_carry = lambda h: h.to(torch.bfloat16).float()
    gk.bwd_product = lambda dhw, w_t: dhw.to(torch.bfloat16).float() @ w_t
    try:
        out_p = gk.gru_fwd_seq_reference(*fwd)
        grads_p = gk.gru_bwd_seq_reference(fwd[0], dys, *out_k[1:], hprev)
        gk.fwd_carry, gk.bwd_product = carry, product
        gk.fwd_product = lambda h, w, dt: h.to(torch.bfloat16).float() @ w
        out_1 = gk.gru_fwd_seq_reference(*fwd) if dtype == torch.float32 else None
        gk.fwd_product = fwd_product
        gk.bwd_carry = lambda dh, dt: dh.to(dt).float()
        grads_c = (gk.gru_bwd_seq_reference(fwd[0], dys, *out_k[1:], hprev)
                   if dtype == torch.bfloat16 else None)
    finally:
        gk.fwd_carry, gk.fwd_product = carry, fwd_product
        gk.bwd_product, gk.bwd_carry = product, bwd_carry
    torch.cuda.synchronize()
    errs = {"K5 carry rounded to bf16": _train_kernel_errs(out_k, out_p),
            "K6 product on bf16 dhw": _train_kernel_errs(grads_k, grads_p)}
    if out_1 is not None:
        errs["K5 product on h as one bf16 piece"] = _train_kernel_errs(out_k, out_1)
    if grads_c is not None:
        errs["K6 dh carried in bf16"] = _train_kernel_errs(grads_k, grads_c)
    max_b, mean_b = TRAIN_BOUNDS[dtype]
    print(f"[kernels] planted faults {dtype}: " + "; ".join(
        f"{name} max/mean {e[0]:.3e}/{e[1]:.3e}" for name, e in errs.items()), flush=True)
    for name, e in errs.items():
        if e[0] <= max_b and e[1] <= mean_b:
            raise RuntimeError(f"a planted fault passes the {dtype} bounds: {name}")


def _by_cluster(gk, kernel: str, dtype, hidden, call):
    """{C: (outputs, ms)} of ``call()`` with K5's (``kernel`` "fwd") or K6's
    ("bwd") plan forced to each cluster size its width and dtype allow."""
    plan = f"{kernel}_plan"
    real, got = getattr(gk, plan), {}
    sizes, stages = getattr(gk, f"{kernel}_cluster_sizes"), getattr(gk, f"{kernel}_ring_stages")
    for c in sizes(hidden, dtype):
        setattr(gk, plan, lambda hidden, dtype, c=c: gk.LaunchPlan(
            c, stages(hidden // c, gk.bwd_weight_pieces(dtype))))
        try:
            got[c] = (call(), cuda_ms(call, 5))
        finally:
            setattr(gk, plan, real)
    return got


def phase_train_kernels(card: str) -> dict:
    """K5 and K6 against their plain versions at the VAE's shapes: the
    encoder's (24 steps, 4,096 rows, both directions, h0 zero), the beat
    GRU's (4 steps, 4,096 rows) and the tick GRU's (6 steps, 16,384 rows =
    4,096 x 4 beats), H 512, f32 and bf16; K6 at every cluster size,
    bit-equal to the others (its cluster only moves dhw's pieces). The
    planted faults at the encoder's shape; the times of the forward
    direction at each shape, K5 and K6 at each cluster size. -> report
    entries of the bf16 encoder case."""
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk

    hidden, rows = 512, TRAIN_WINDOWS * N_BARS
    cases = [("encoder", 24, rows, False, True), ("encoder", 24, rows, True, True),
             ("beat", 4, rows, False, False), ("tick", 6, rows * 4, False, False)]
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, steps, batch, reverse, zero_h0 in cases:
            fwd, dys = _train_kernel_case(steps + reverse, batch, steps, hidden, dtype, zero_h0)
            out_k, grads_k, hprev = _run_k5_k6(fwd, dys, reverse, gk)
            out_p = gk.gru_fwd_seq_reference(*fwd, reverse=reverse)
            # K6's plain version on the kernel's gates: the same inputs as K6
            grads_p = gk.gru_bwd_seq_reference(fwd[0], dys, *out_k[1:], hprev, reverse=reverse)
            torch.cuda.synchronize()
            e_fwd, e_bwd = _train_kernel_errs(out_k, out_p), _train_kernel_errs(grads_k, grads_p)
            max_b, mean_b = TRAIN_BOUNDS[dtype]
            plan, fplan = gk.bwd_plan(hidden, dtype), gk.fwd_plan(hidden, dtype)
            print(f"[kernels] {dtype} {label} steps {steps} rows {batch} reverse {reverse}: "
                  f"gru_fwd_seq max/mean {e_fwd[0]:.3e}/{e_fwd[1]:.3e} (abs {e_fwd[2]:.3e}; "
                  f"cluster {fplan.cluster}, stages {fplan.stages}), "
                  f"gru_bwd_seq {e_bwd[0]:.3e}/{e_bwd[1]:.3e} (abs {e_bwd[2]:.3e}; cluster "
                  f"{plan.cluster}, stages {plan.stages}) (bounds {max_b:.0e}/{mean_b:.0e})",
                  flush=True)
            for e in (e_fwd, e_bwd):
                if not (e[0] <= max_b and e[1] <= mean_b):
                    raise RuntimeError(f"K5/K6 disagree with their plain versions: {dtype} {label}")
            if not all(bool(torch.isfinite(t.float()).all()) for t in (*out_k, *grads_k)):
                raise RuntimeError(f"non-finite K5/K6 output: {dtype} {label}")
            by_c5 = _by_cluster(gk, "fwd", dtype, hidden,
                                lambda: gk.gru_fwd_seq(*fwd, reverse=reverse))
            by_c = _by_cluster(gk, "bwd", dtype, hidden, lambda: gk.gru_bwd_seq(
                fwd[0], dys, *out_k[1:], hprev, reverse=reverse))
            for name, got, ref in (("gru_fwd_seq", by_c5, out_k), ("gru_bwd_seq", by_c, grads_k)):
                same = all(all(torch.equal(x, y) for x, y in zip(g, ref)) for g, _ in got.values())
                print(f"[kernels] {name} {dtype} {label} reverse {reverse}: clusters "
                      f"{sorted(got)} bit-equal {same}", flush=True)
                if not same:
                    raise RuntimeError(f"{name} differs across cluster sizes: {dtype} {label}")
            if reverse:
                continue
            if label == "encoder":
                _reject_train_faults(fwd, dys, out_k, grads_k, hprev, dtype, gk)
            b_fwd, b_bwd = _k5_k6_bounds(steps, batch, hidden, dtype, fwd, out_k, grads_k,
                                         dys, hprev)
            bwd_args = (fwd[0], dys, *out_k[1:], hprev)
            times = {
                "gru_fwd_seq": (by_c5[fplan.cluster][1],
                                cuda_ms(lambda: gk.gru_fwd_seq_reference(*fwd), 2), b_fwd, e_fwd),
                "gru_bwd_seq": (by_c[plan.cluster][1],
                                cuda_ms(lambda: gk.gru_bwd_seq_reference(*bwd_args), 2), b_bwd,
                                e_bwd),
            }
            for name, (ms, plain_ms, b, e) in times.items():
                if name == "gru_bwd_seq":
                    per = ", ".join(f"cluster {c} {v[1]:.3f} ms" for c, v in by_c.items())
                    extra = (f" (cluster {plan.cluster}, stages {plan.stages}; {per}), "
                             f"f32 FMA bound {b['bound_f32_fma_ms']:.3f} ms,")
                else:
                    per = ", ".join(f"cluster {c} {v[1]:.3f} ms" for c, v in by_c5.items())
                    extra = f" (cluster {fplan.cluster}, stages {fplan.stages}; {per}),"
                    print(f"[plan] gru_fwd_seq {dtype} {label}: cluster {fplan.cluster}, stages "
                          f"{fplan.stages} | {card}", flush=True)
                print(f"[time] {name} {dtype} {label} steps {steps} rows {batch}: kernel "
                      f"{ms:.3f} ms{extra} plain {plain_ms:.3f} ms (kernel/plain "
                      f"{ms / plain_ms:.2f}x), bound {b['bound_ms']:.3f} ms ({b['bound_by']}) "
                      f"| {card}", flush=True)
                if dtype == torch.bfloat16 and label == "encoder":
                    report[name] = {"max_abs_err": e[2], "ms": ms, "plain_ms": plain_ms, **b,
                                    "library_ms": None}
    return report


def phase_train_reference(card: str):
    """One VAE train step on the card (K5, K6) against the same step on the
    CPU (plain versions), f32, small geometry (vocab 60, E 10, H 64, z 16, 2
    layers, dropout 0.5/0.5, 8 windows x 2 bars), the same initial
    parameters, dropout masks (one seeded CPU generator per trainer: masks
    drawn on the CPU, moved to the card) and injected rsample noise; one step
    with each teacher-forcing coin, in turn. Loss, every gradient and the
    parameters after each Adam step are compared."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
    from inpaintnet_tpu_torch.train.data import ArrayDataset
    from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

    rng = np.random.default_rng(6)
    windows = rng.integers(0, VOCAB, (8, 1, 2 * 24)).astype(np.int32)
    data = ArrayDataset((windows,), n_bars=2)
    vocab = VocabOnlyDataset(VOCAB)

    def trainer(device):
        model = MeasureVAE(vocab, note_embedding_dim=10, encoder_hidden_size=64,
                           latent_space_dim=16, decoder_hidden_size=64, device="cpu", seed=1)
        tr = VAETrainer(data, model, lr=1e-3, device=device)
        tr.generator = torch.Generator().manual_seed(3)
        return tr

    card_tr, cpu_tr = trainer("cuda"), trainer("cpu")
    for coin in (True, False):
        eps = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
        out = {}
        for name, tr in (("card", card_tr), ("cpu", cpu_tr)):
            loss, _ = tr.train_step(tr.process_batch_data((windows,)), eps=eps.to(tr.device),
                                    coin=coin)
            leaves = [p for _, p in iter_leaves(tr.params)]
            out[name] = (loss.item(), [p.grad.cpu() for p in leaves],
                         [p.detach().cpu() for p in leaves])
        (l_c, g_c, p_c), (l_p, g_p, p_p) = out["card"], out["cpu"]
        loss_err = abs(l_c - l_p) / abs(l_p)
        g_err = max(((a - b).abs() / (1.0 + b.abs())).max().item() for a, b in zip(g_c, g_p))
        p_diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p_c, p_p)])
        print(f"[train-ref] coin {coin}: loss card {l_c:.7f} cpu {l_p:.7f} rel err {loss_err:.3e} "
              f"(bound {TRAIN_REF['loss']:.0e}); gradients max |d|/(1+|g|) {g_err:.3e} (bound "
              f"{TRAIN_REF['grad']:.0e}); post-Adam params max {p_diff.max().item():.3e} "
              f"(bound {TRAIN_REF['param_max']:.0e}), mean {p_diff.mean().item():.3e} "
              f"(bound {TRAIN_REF['param_mean']:.0e}) | {card}", flush=True)
        if not (loss_err <= TRAIN_REF["loss"] and g_err <= TRAIN_REF["grad"]
                and p_diff.max().item() <= TRAIN_REF["param_max"]
                and p_diff.mean().item() <= TRAIN_REF["param_mean"]):
            raise RuntimeError(f"the train step on the card disagrees with the CPU (coin {coin})")


def _profile_step(step) -> tuple:
    """``torch.profiler``'s device time of one ``step()``. -> (device ms,
    device launches, [(kernel, ms, launches)] by time, longest first). A
    trace may lose the kernels at its start on the card (a whole window
    once, a call's first kernel or two another time), so each trace starts
    with a lead: a pause of ``PROFILE_LEAD_S`` on the host, then
    ``PROFILE_LEAD_SPINS`` short ``torch.cuda._sleep`` kernels and one of a
    few milliseconds, which are left out of the rows (the lead's kernels
    the trace lost are counted in ``LEADS_LOST``); a trace that recorded no
    device activity at all is taken again, up to twice."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(PROFILE_LEAD_S)
            for _ in range(PROFILE_LEAD_SPINS):
                torch.cuda._sleep(PROFILE_LEAD_SPIN_CYCLES)
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
            torch.cuda.synchronize()
            step()
            torch.cuda.synchronize()
        rows = _kernel_rows(prof)
        LEADS_LOST[1] += PROFILE_LEAD_SPINS + 1
        LEADS_LOST[0] += PROFILE_LEAD_SPINS + 1 - sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" in e.key)
        if rows:
            break
        print(f"[profile] no device activity recorded (attempt {attempt + 1}); tracing again",
              flush=True)
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


# the lead of a trace: 20 ms on the host, then 32 short kernels and ~10 ms
# of a card's clock before the traced call. A trace of phase 24 once lost
# the traced call's first kernel six times running behind a lead of ~5 ms
# alone, and again behind one ~10 ms kernel. Late in a full run a trace
# loses ~10 of its first kernels (1,119 of 3,894 lead kernels in one), in a
# fresh process none of 200 traces lost one (NVIDIA H100 80GB HBM3)
PROFILE_LEAD_S = 0.02
PROFILE_LEAD_SPINS = 32
PROFILE_LEAD_SPIN_CYCLES = 1_000
PROFILE_LEAD_CYCLES = 20_000_000
# [the lead's kernels the traces lost, the lead's kernels launched]
LEADS_LOST = [0, 0]


def _kernel_rows(prof, skip=()) -> list:
    """[(kernel, device ms, launches)] of a trace, leaving out the lead's
    ``spin_kernel`` and the device ranges of the ``record_function`` labels
    in ``skip``."""
    rows = []
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key
                and e.key not in skip):
            us = getattr(e, "self_device_time_total", None)
            rows.append((e.key, (e.self_cuda_time_total if us is None else us) / 1e3, e.count))
    return rows


def _profile_retaken(count, call, want: int):
    """``count(_profile_step(call))`` (a tuple whose second item is the
    launches of the kernels it counts), traced again up to twice while
    fewer than ``want`` show: a trace that lost a kernel. The last reading
    otherwise, for the caller to reject."""
    for _ in range(3):
        got = count(_profile_step(call))
        if got[1] >= want:
            break
    return got


def _device_ms(call, key: str) -> float:
    """Device ms of the kernels whose names hold ``key`` in one ``call()``
    (``torch.profiler``): a wrapper's kernel without its operand work;
    traced again up to twice while no such kernel shows (a trace that lost
    it)."""
    for _ in range(3):
        ms = sum(ms for name, ms, _ in _profile_step(call)[2] if key in name)
        if ms > 0:
            break
    return ms


def _profile_line(tag: str, call, wall: float, card: str, top: int = 8) -> None:
    """Print the device time, launches and idle share (1 - device time /
    ``wall``, the unprofiled wall of the same call) of one ``call()``, and
    the kernels taking the most device time."""
    device_ms, count, rows = _profile_step(call)
    print(f"[profile] {tag}: device {device_ms:.2f} ms a call, {count} launches, idle share "
          f"{1 - device_ms / wall:.3f} (of the unprofiled {wall:.2f} ms) | {card}", flush=True)
    for name, k_ms, k_count in rows[:top]:
        print(f"[profile]   {k_ms:9.3f} ms {k_count:6d}x  {name[:110]}", flush=True)


def phase_trainer(card: str) -> dict:
    """The full-width VAE trainer takes 8 steps in f32 and 8 in bf16 compute
    (coins alternating, teacher-forced first); per step K5 and K6 must
    launch as ``TRAIN_LAUNCHES`` says, the loss must be finite, and the
    parameters must have moved. Steps 0-1 warm up; ms per step is the mean
    of the two branches' medians over steps 2-5 (the coin is fair); steps
    6-7, one a branch, run under ``torch.profiler``, which prints the
    device time and launches a step, the idle share (1 - device time / the
    branch's median wall) and the kernels taking the most device time.
    -> {kernel: launches}."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.train.data import ArrayDataset
    from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

    model = MeasureVAE(VocabOnlyDataset(VOCAB), device="cuda", seed=0)
    windows = np.random.default_rng(7).integers(
        0, VOCAB, (TRAIN_WINDOWS, 1, N_BARS * 24)).astype(np.int32)
    data = ArrayDataset((windows,), N_BARS)
    rows = TRAIN_WINDOWS * N_BARS
    kernels = (gk.gru_fwd_seq, gk.gru_bwd_seq)

    def drive():
        for compute in (None, "bfloat16"):
            tr = VAETrainer(data, model, lr=1e-4, device="cuda", compute_dtype=compute)
            start = [p.detach().clone() for _, p in iter_leaves(tr.params)]
            batch = tr.process_batch_data((windows,))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, profiles = {True: [], False: []}, {}
            for i, coin in enumerate((True, False) * 4):
                before = [k.launches for k in kernels]
                if i >= 6:
                    out = []
                    profiles[coin] = _profile_step(
                        lambda: out.append(tr.train_step(batch, coin=coin)[0]))
                    loss = out[0].item()
                else:
                    t0 = time.perf_counter()
                    loss, _ = tr.train_step(batch, coin=coin)
                    loss = loss.item()  # waits for the step
                    times[coin].append((time.perf_counter() - t0) * 1e3)
                got = [k.launches - b for k, b in zip(kernels, before)]
                if got != [TRAIN_LAUNCHES[coin]] * 2 or not np.isfinite(loss):
                    raise RuntimeError(f"train step {i} (coin {coin}): K5/K6 launches {got}, "
                                       f"expected {TRAIN_LAUNCHES[coin]} each; loss {loss}")
            peak = torch.cuda.max_memory_allocated()
            moved = sum((p.detach() - s).abs().sum().item()
                        for (_, p), s in zip(iter_leaves(tr.params), start))
            if not moved > 0:
                raise RuntimeError("the parameters did not move")
            walls = {c: float(np.median(times[c][1:])) for c in (True, False)}
            ms = (walls[True] + walls[False]) / 2
            label = compute or "float32"
            print(f"[trainer] {label} compute: {rows} measure rows a step; "
                  f"{ms:.2f} ms/step (teacher-forced {walls[True]:.2f}, sampling "
                  f"{walls[False]:.2f}), {rows / (ms / 1e3):.1f} measures/s, peak memory "
                  f"{peak / 2**30:.2f} GiB, last loss {loss:.5f}, K5/K6 launches a step "
                  f"{TRAIN_LAUNCHES} | {card}", flush=True)
            for coin, (device_ms, count, kernel_rows) in profiles.items():
                branch = "teacher-forced" if coin else "sampling"
                print(f"[profile] {label} {branch}: device {device_ms:.2f} ms/step, {count} "
                      f"launches/step, idle share {1 - device_ms / walls[coin]:.3f} (of the "
                      f"unprofiled median wall {walls[coin]:.2f} ms) | {card}", flush=True)
                for name, k_ms, k_count in kernel_rows[:12]:
                    print(f"[profile]   {k_ms:9.3f} ms {k_count:6d}x  {name[:110]}", flush=True)
            del tr, batch, start
            torch.cuda.empty_cache()

    _, launches = _launches_during(kernels, drive)
    print(f"[trainer] K5/K6 launches in the trainer's steps: {launches}", flush=True)
    return launches


def latent_train_launches(auto_reg: bool, coin, max_target: int) -> dict:
    """K2, K5 and K6 launches a LatentRNN training step: one decode and one
    encode (4 K5 layer-directions) a step, or on the autoregressive sampled
    branch ``max_target`` decodes, the context encode plus ``max_target -
    1`` re-encodes, and the unmasked generation GRU's (hidden 1024, or 1,536
    in phase 28) 2 layers x 2 directions a target step on K5 forward and K6
    backward; K6 for
    nothing else (nothing upstream of the frozen encoder needs a
    gradient)."""
    sampled = auto_reg and not coin
    return {"decode_sampling": max_target if sampled else 1,
            "gru_fwd_seq": 8 * max_target if sampled else 4,
            "gru_bwd_seq": 4 * max_target if sampled else 0}


def _recorded_tokens(decoder) -> list:
    """Wrap ``decoder.decode_sampling`` (the instance's) to keep the tokens
    of every forward decode; -> the list they go into."""
    seen, real = [], decoder.decode_sampling

    def recorded(*a, **k):
        out = real(*a, **k)
        seen.append(out[1].detach().cpu())
        return out

    decoder.decode_sampling = recorded
    return seen


def phase_latent_train_reference(card: str) -> None:
    """LatentRNN train steps on the card (K5, K2 with its eager backward)
    against the same steps on the CPU (plain versions), f32, phase 15's
    geometry (vocab 60, E 10, H 64, generation hidden 128, z 16) on 4
    windows of 16 bars: the same parameters, split and injected rsample
    noise, every dropout 0 but the frozen decoder's 0.5 (the argmax decode
    never applies it). The non-autoregressive model and the autoregressive
    one on each coin take two Adam steps (lr 1e-3) each: the tokens of the
    K2 forward must equal the CPU's (a flipped argmax near-tie is reported
    and fails the phase), and loss, gradients and parameters after each
    step stay within ``TRAIN_REF``, phase 9's bounds for phase 9's
    reasons."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
    from inpaintnet_tpu_torch.ops import decode_kernel
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.train import LatentRNNTrainer
    from inpaintnet_tpu_torch.train.data import ArrayDataset

    rng = np.random.default_rng(16)
    b, z_dim = 4, 16
    windows = rng.integers(0, VOCAB, (b, 1, N_BARS * 24)).astype(np.int32)
    data = ArrayDataset((windows,), N_BARS)
    kernels = (decode_kernel.decode_sampling, gk.gru_fwd_seq, gk.gru_bwd_seq)
    for label, auto_reg, coin in (("non-autoregressive", False, None),
                                  ("autoregressive heads", True, True),
                                  ("autoregressive tails", True, False)):
        vae = MeasureVAE(VocabOnlyDataset(VOCAB), note_embedding_dim=10, encoder_hidden_size=64,
                         latent_space_dim=z_dim, decoder_hidden_size=64, device="cpu", seed=4,
                         encoder_dropout_prob=0.0)
        model = LatentRNN(vae, 2, 64, auto_reg, device="cpu", dropout=0.0, seed=5)
        mt = model.max_target
        tokens = _recorded_tokens(vae.decoder)
        trainers = {dev: LatentRNNTrainer(data, model, lr=1e-3, device=dev, seed=1)
                    for dev in ("cuda", "cpu")}
        for step in range(2):
            measures = 2 * N_BARS + (mt if model.use_teacher_forcing else 0)
            eps = torch.from_numpy(rng.standard_normal((b * measures, z_dim)).astype(np.float32))
            eps_steps = torch.from_numpy(
                rng.standard_normal((mt - 1, b, z_dim)).astype(np.float32))
            out = {}
            for dev, tr in trainers.items():
                tokens.clear()
                before = [k.launches for k in kernels]
                loss, _ = tr.train_step(tr.process_batch_data((windows,)), eps=eps.to(tr.device),
                                        eps_steps=eps_steps.to(tr.device), coin=coin)
                leaves = [p for _, p in iter_leaves(tr.params)]
                out[dev] = (loss.item(),
                            [torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
                             for p in leaves],
                            [p.detach().cpu() for p in leaves], torch.cat(tokens),
                            [k.launches - n for k, n in zip(kernels, before)])
            (l_c, g_c, p_c, t_c, n_c), (l_p, g_p, p_p, t_p, _) = out["cuda"], out["cpu"]
            agree = (t_c == t_p).float().mean().item()
            loss_err = abs(l_c - l_p) / abs(l_p)
            g_err = max(((a - c).abs() / (1.0 + c.abs())).max().item() for a, c in zip(g_c, g_p))
            p_diff = torch.cat([(a - c).abs().flatten() for a, c in zip(p_c, p_p)])
            print(f"[latent-train-ref] {label} step {step}: K2 tokens equal {agree:.6f} (bound "
                  f"1); loss card {l_c:.7f} cpu {l_p:.7f} rel err {loss_err:.3e} (bound "
                  f"{TRAIN_REF['loss']:.0e}); gradients max |d|/(1+|g|) {g_err:.3e} (bound "
                  f"{TRAIN_REF['grad']:.0e}); post-Adam params max {p_diff.max().item():.3e} "
                  f"(bound {TRAIN_REF['param_max']:.0e}), mean {p_diff.mean().item():.3e} "
                  f"(bound {TRAIN_REF['param_mean']:.0e}); K2/K5/K6 launches on the card "
                  f"{n_c} | {card}", flush=True)
            if agree < 1.0:
                flips = (t_c != t_p).nonzero()[:4].tolist()
                raise RuntimeError(f"{label} step {step}: K2's argmax differs from the CPU's at "
                                   f"(row, tick) {flips}: a near-tie flipped a token")
            if not (loss_err <= TRAIN_REF["loss"] and g_err <= TRAIN_REF["grad"]
                    and p_diff.max().item() <= TRAIN_REF["param_max"]
                    and p_diff.mean().item() <= TRAIN_REF["param_mean"]):
                raise RuntimeError(f"the LatentRNN train step on the card disagrees with the CPU "
                                   f"({label}, step {step})")


def phase_latent_trainer(card: str) -> dict:
    """The full-width LatentRNN trainer at ``train_inpaintnet.py``'s defaults
    (vocab 60, E 10, VAE GRUs of hidden 512, z 256, LatentRNN hidden 512,
    every dropout 0.5, lr 1e-4, 32 windows of 16 bars), random weights from
    seed 0: the non-autoregressive flagship and the autoregressive one with
    teacher forcing, each in f32 and in bf16 compute, 8 steps (the
    autoregressive coins alternating, heads first). Per step: K2, K5 and K6
    launch as ``latent_train_launches`` says; the loss is finite; on the
    warm-up steps the masked generation GRU's hidden-1024 steps (6 target
    steps x 2 layers x 2 directions) run in the eager loop, and on the
    autoregressive sampled branch none does (K5/K6 run them). After
    the steps the LatentRNN's parameters moved and every VAE parameter is
    bit-unchanged; one validation step launches K1 and K2 (once, or a
    context encode and 5 re-encodes and 6 decodes when autoregressive).
    Steps 0-1 warm up, 2-5 are timed (ms a step: the mean of the branches'
    medians), 6-7 profiled one a branch (``_profile_step``). -> {kernel:
    launches} over the whole phase."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops import decode_kernel, encoder_kernel
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.train import LatentRNNTrainer
    from inpaintnet_tpu_torch.train.data import ArrayDataset

    rng = np.random.default_rng(17)
    windows = rng.integers(0, VOCAB, (LATENT_WINDOWS, 1, N_BARS * 24)).astype(np.int32)
    data = ArrayDataset((windows,), N_BARS)
    kernels = (encoder_kernel.encoder_hn, decode_kernel.decode_sampling, gk.gru_fwd_seq,
               gk.gru_bwd_seq)
    train_kernels = kernels[1:]

    def drive():
        for auto_reg in (False, True):
            _, vae, model = build_flagship(seed=0, device="cuda", auto_reg=auto_reg)
            mt, gen = model.max_target, model.gen_hidden_size
            vae_before = {k: v.clone() for k, v in vae.state_dict().items()}
            mode = "autoregressive" if auto_reg else "non-autoregressive"
            coins = (True, False) * 4 if auto_reg else (None,) * 8
            for compute in (None, "bfloat16"):
                label = f"{mode} {compute or 'float32'}"
                tr = LatentRNNTrainer(data, model, lr=1e-4, device="cuda",
                                      compute_dtype=compute, seed=1)
                start = [p.detach().clone() for _, p in iter_leaves(tr.params)]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times, measures, profiles = {}, [], {}
                for i, coin in enumerate(coins):
                    batch = tr.process_batch_data((windows,))
                    valid = int(batch[5].sum().item())  # valid target measures
                    before = [k.launches for k in train_kernels]
                    eager = None
                    if i >= 6:
                        out = []
                        profiles[coin] = _profile_step(
                            lambda: out.append(tr.train_step(batch, coin=coin)[0]))
                        loss = out[0].item()
                    elif i < 2:
                        (loss, _), eager = _eager_gru_steps(
                            lambda: tr.train_step(batch, coin=coin), gen)
                        loss = loss.item()
                    else:
                        t0 = time.perf_counter()
                        loss, _ = tr.train_step(batch, coin=coin)
                        loss = loss.item()  # waits for the step
                        times.setdefault(coin, []).append((time.perf_counter() - t0) * 1e3)
                        measures.append(valid)
                    got = {k.__name__: k.launches - n for k, n in zip(train_kernels, before)}
                    want = latent_train_launches(auto_reg, coin, mt)
                    if got != want or not np.isfinite(loss):
                        raise RuntimeError(f"{label} step {i} (coin {coin}): launches {got}, "
                                           f"expected {want}; loss {loss}")
                    want_eager = 0 if auto_reg and coin is False else mt * 4
                    if eager is not None and eager != want_eager:
                        raise RuntimeError(f"{label} step {i} (coin {coin}): {eager} eager "
                                           f"generation-GRU steps of hidden {gen}, expected "
                                           f"{want_eager}: the layer left its route")
                peak = torch.cuda.max_memory_allocated()
                moved = sum((p.detach() - s).abs().sum().item()
                            for (_, p), s in zip(iter_leaves(tr.params), start))
                if not moved > 0:
                    raise RuntimeError(f"{label}: the LatentRNN's parameters did not move")
                changed = [k for k, v in vae.state_dict().items() if not torch.equal(v, vae_before[k])]
                if changed:
                    raise RuntimeError(f"{label}: the frozen VAE changed: {changed[:4]}")
                before = [k.launches for k in kernels]
                val_loss, _ = tr.eval_step(tr.process_batch_data((windows,)))
                val = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
                want_val = {"encoder_hn": mt if auto_reg else 1,
                            "decode_sampling": mt if auto_reg else 1,
                            "gru_fwd_seq": 0, "gru_bwd_seq": 0}
                if val != want_val or not np.isfinite(val_loss.item()):
                    raise RuntimeError(f"{label} validation step: launches {val}, expected "
                                       f"{want_val}; loss {val_loss.item()}")
                walls = {c: float(np.median(t)) for c, t in times.items()}
                ms = float(np.mean(list(walls.values())))
                per_step = float(np.mean(measures))
                branches = ", ".join(f"{'teacher-forced' if c else 'sampled'} {w:.2f}"
                                     for c, w in walls.items() if c is not None)
                print(f"[latent-trainer] {label}: {ms:.2f} ms/step"
                      + (f" ({branches})" if branches else "")
                      + f", {LATENT_WINDOWS / (ms / 1e3):.1f} windows/s, "
                      f"{per_step / (ms / 1e3):.1f} valid target measures/s ({per_step:.1f} a "
                      f"step), peak memory {peak / 2**30:.2f} GiB, last loss {loss:.5f}, "
                      f"validation loss {val_loss.item():.5f}; K2/K5/K6 launches a step "
                      f"{[latent_train_launches(auto_reg, c, mt) for c in walls]}, validation "
                      f"{val}; VAE bit-unchanged | {card}", flush=True)
                for coin, (device_ms, count, kernel_rows) in profiles.items():
                    branch = {None: "step", True: "teacher-forced", False: "sampled"}[coin]
                    print(f"[profile] latent {label} {branch}: device {device_ms:.2f} ms/step, "
                          f"{count} launches/step, idle share {1 - device_ms / walls[coin]:.3f} "
                          f"(of the unprofiled median wall {walls[coin]:.2f} ms) | {card}",
                          flush=True)
                    for name, k_ms, k_count in kernel_rows[:12]:
                        print(f"[profile]   {k_ms:9.3f} ms {k_count:6d}x  {name[:110]}",
                              flush=True)
                del tr, start
                torch.cuda.empty_cache()
            del vae, model, vae_before

    for k in kernels:
        k.launches = 0
    drive()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"[latent-trainer] launches in the phase: {launches}", flush=True)
    if min(launches[n] for n in ("encoder_hn", "decode_sampling", "gru_fwd_seq",
                                 "gru_bwd_seq")) < 1:
        raise RuntimeError(f"the LatentRNN training path launched {launches}")
    return launches


def _request(rng, batch: int, n_past: int, n_target: int, n_future: int):
    m = n_past + n_target + n_future
    return rng.integers(0, VOCAB, (batch, m, 24)).astype(np.int32), n_past, n_target


def _check_response(out, tokens, start: int, num: int, vocab: int = VOCAB):
    if out.shape != tokens.shape:
        raise RuntimeError(f"response shape {out.shape} != request {tokens.shape}")
    if out.min() < 0 or out.max() >= vocab:
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
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.inpaint(tokens, start, num, seed=5)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    one, s1, n1 = requests[0][1:]
    lat = [cuda_ms(lambda: engine.inpaint(one, s1, n1, seed=5), 1) for _ in range(20)]
    rate = BATCH * N_TARGET / (t_big / 1e3)
    route = _route_name(engine)
    print(f"[time] engine {dtype} ({route}) batch {BATCH} 6/4/6: {t_big:.2f} ms per call, "
          f"{rate:.1f} measures/s, peak {peak:.2f} GiB above the {base / 2**30:.2f} GiB held "
          f"| {card}", flush=True)
    print(f"[time] engine {dtype} ({route}) batch 1 2-measure: p50 {np.median(lat):.2f} ms "
          f"(p90 {np.percentile(lat, 90):.2f} ms) | {card}", flush=True)
    if dtype == "int8":  # the bf16 engine's profiles: phase_gru_routes
        _profile_line(f"engine int8 ({route}) batch {BATCH}",
                      lambda: engine.inpaint(tokens, start, num, seed=5), t_big, card)
        _profile_line(f"engine int8 ({route}) batch 1",
                      lambda: engine.inpaint(one, s1, n1, seed=5), float(np.median(lat)), card)
    return engine, launches, outs[2][:, start:start + num]


def phase_f32_engine(model, card: str) -> dict:
    """The flagship f32 engine under ``"pallas"``, the path that runs K2's
    and K8's f32 routes (and K1's): three requests checked, K1, K2 and K8
    launches per call asserted, then measures/s at batch 2048 (6/4/6), the
    batch-1 p50 and a profile of each. -> {kernel: launches a call}"""
    from inpaintnet_tpu_torch.ops.decode_kernel import decode_sampling
    from inpaintnet_tpu_torch.ops.encoder_kernel import encoder_hn
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.ops.gru_kernel import gru_layer_stream
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    engine = InpaintingEngine(model, batch_buckets=BUCKETS, dtype="float32", device="cuda")
    kernels = (encoder_hn, decode_sampling, gru_layer_stream)
    want = {"encoder_hn": 1, "decode_sampling": 1,
            "gru_layer_stream": k8_launches_per_call(engine.max_target, False)}
    rng = np.random.default_rng(17)
    requests = [("batch 1, 2-measure span", *_request(rng, 1, 7, 2, 7)),
                ("batch 8, 6/4/6", *_request(rng, 8, N_PAST, N_TARGET, N_FUTURE)),
                (f"batch {BATCH}, 6/4/6", *_request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE))]
    with gru_impl_scope("pallas"):
        engine.warmup()
        for label, tokens, start, num in requests:
            before = [k.launches for k in kernels]
            out = engine.inpaint(tokens, start, num, seed=11)
            got = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
            _check_response(out, tokens, start, num)
            if not np.array_equal(out, engine.inpaint(tokens, start, num, seed=11)):
                raise RuntimeError(f"f32 engine {label}: the same seed gave other tokens")
            if got != want:
                raise RuntimeError(f"f32 engine {label}: launches {got}, expected {want}")
            print(f"[f32-engine] {label}: ok, launches a call {got}, "
                  f"{(out[:, start:start + num] != tokens[:, start:start + num]).mean():.3f} of "
                  f"span tokens differ from the input", flush=True)
        big, one = requests[2][1:], requests[0][1:]
        t_big = cuda_ms(lambda: engine.inpaint(*big, seed=5), 3)
        lat = [cuda_ms(lambda: engine.inpaint(*one, seed=5), 1) for _ in range(20)]
        route = _route_name(engine)
        print(f"[time] engine float32 pallas ({route}) batch {BATCH} 6/4/6: {t_big:.2f} ms per "
              f"call, {BATCH * N_TARGET / (t_big / 1e3):.1f} measures/s | {card}", flush=True)
        print(f"[time] engine float32 pallas ({route}) batch 1 2-measure: p50 "
              f"{np.median(lat):.2f} ms (p90 {np.percentile(lat, 90):.2f} ms) | {card}",
              flush=True)
        _profile_line(f"engine f32 pallas ({route}) batch {BATCH}",
                      lambda: engine.inpaint(*big, seed=5), t_big, card)
        _profile_line(f"engine f32 pallas ({route}) batch 1",
                      lambda: engine.inpaint(*one, seed=5), float(np.median(lat)), card)
    return want


def phase_reference(model, quantized: bool = True):
    """The main path on the card (kernels) against the same model on the
    CPU (plain versions) on a small input with shared noise, f32 masters:
    unquantized (z and tokens), and with ``quantized`` int8 on a model of H
    ``INT8_REF_HIDDEN``, where the JAX package quantizes (z, by median and
    max; the random weights' near-flat logits turn a flipped carry rounding
    into other argmax tokens, so the token share is printed). The
    unquantized path on the card against the int8 path on the CPU must fail
    both int8 bounds, or they could not tell the two apart. K3 and K4 at the
    engine's bf16 masters are held to their plain versions in phase 3."""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.models.presets import build_flagship

    rng = np.random.default_rng(3)
    b = 4
    past = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    future = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    pm = (np.arange(N_BARS) < N_PAST)[None].repeat(b, 0).astype(np.float32)
    fm = (np.arange(N_BARS) < N_FUTURE)[None].repeat(b, 0).astype(np.float32)
    fm[0] = 0  # a row with no future context
    tm = (np.arange(model.max_target) < N_TARGET)[None].repeat(b, 0).astype(np.float32)
    eps = rng.standard_normal((b * 2 * N_BARS, model.z_dim)).astype(np.float32)

    def run(net, dev, quant):
        params = cast_params(net.params(), dev, torch.float32)
        vae_params = cast_params(net.vae_model.params(), dev, torch.float32)
        args = [torch.from_numpy(a).to(dev) for a in (past, future, pm, fm, tm, eps)]
        with torch.inference_mode():
            lg, s, z = net.apply(params, vae_params, args[0], args[1], None,
                                 past_mask=args[2], future_mask=args[3],
                                 target_mask=args[4], eps=args[5], quant=quant)
        return lg.cpu(), s.cpu(), z.cpu()

    outs = {(dev, "none"): run(model, dev, "none") for dev in ("cuda", "cpu")}

    def compare(card_quant, cpu_quant):
        (lg, s, z), (_, s_cpu, z_cpu) = outs["cuda", card_quant], outs["cpu", cpu_quant]
        err = (z - z_cpu).abs()
        return (err.max().item(), err.median().item(), (s == s_cpu).float().mean().item(),
                bool(torch.isfinite(lg).all()))

    z_max, _, agree, ok = compare("none", "none")
    print(f"[reference] f32 main path at V {model.vae_model.decoder.num_notes}, card vs CPU plain: "
          f"gen z "
          f"max_abs_err {z_max:.3e} (bound 1e-3), tokens equal {agree:.4f} (bound 0.99), finite "
          f"{ok}", flush=True)
    if not (z_max <= 1e-3 and agree >= 0.99 and ok):
        raise RuntimeError("the f32 main path on the card disagrees with the CPU")
    if not quantized:
        return
    vocab = model.vae_model.decoder.num_notes
    net = build_flagship(vocab_size=vocab, hidden=INT8_REF_HIDDEN, seed=0, device="cuda")[2]
    vae = net.vae_model
    if not (vae.encoder.quantizes(torch.float32) and vae.decoder.quantizes(torch.float32)):
        raise RuntimeError(f"int8 does not quantize at f32 H {INT8_REF_HIDDEN}")
    outs = {(dev, quant): run(net, dev, quant) for quant in ("none", "int8")
            for dev in ("cuda", "cpu")}
    z_max, z_med, agree, ok = compare("int8", "int8")
    c_max, c_med, _, _ = compare("none", "int8")
    print(f"[reference] int8 main path (f32 masters, H {INT8_REF_HIDDEN}), card vs CPU plain: "
          f"gen z max_abs_err "
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


def _burst(port: int, path: str, reqs, field: str):
    """POST every request at once, one client thread each. -> (each
    response's ``field`` as an array, wall seconds); raises if a client
    failed or hung."""
    results, errors = [None] * len(reqs), []

    def client(i):
        try:
            results[i] = np.asarray(_http(port, "POST", path, reqs[i])[field])
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"{path} clients failed: {errors[:3]}")
    return results, time.perf_counter() - t0


def phase_http(engine, card: str) -> dict:
    """The shared HTTP front end over the int8 engine, dynamic batching
    pinned to bucket 64: concurrent responses must equal solo hetero calls."""
    from inpaintnet_tpu_torch.server import InpaintingServer
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
        (results, wall), launches = _launches_during(
            _kernels_of("int8"), lambda: _burst(port, "/v1/inpaint", reqs, "tokens"))
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


# ---------------------------------------------------------------------------
# The AnticipationRNN path: K7
# ---------------------------------------------------------------------------
ARNN_BATCH, ARNN_BARS, ARNN_SPAN, ARNN_START = 512, 16, 4, 6
ARNN_BUCKETS = (1, 8, 64, 512)
# K7 against its plain version on the card at the engine's batch-512 shapes
# (384 ticks), as ``arnn_kernel.decode_agreement`` measures it: tokens equal
# on a share of all ticks (a sampled tick may flip on an argmax near-tie, and
# its row then decodes its own way), the max and the mean of the logits'
# differences up to each row's first mismatch, that mismatch a near-tie
# within the max, and never at a forced tick. The planted faults (a c carry
# kept in f32 in bf16; a force mask read one tick late) must each break them.
# Seen on an NVIDIA H100 80GB HBM3 (700 W), random flagship weights (their
# logits are near-flat: std 2.7e-3): f32 tokens 1.0, logits max 1.1e-8, mean
# 6.6e-10; bf16 tokens 0.99937, max 6.7e-5, mean 3.9e-6, tie gap 3.1e-5, 3.2%
# of the first 8 ticks' logits changed. The faults: the late force mask
# leaves 97.3% of the tokens equal, but 9 rows first differ at a forced tick
# and the tie gap is 1.4e-2; the c carry in f32 changes 52% of the early
# logits (its max and mean are those of the legitimate rounding flips,
# which cascade over 384 ticks).
ARNN_BOUNDS = {torch.float32: {"tokens": 0.999, "max": 1e-6, "mean": 1e-7},
               torch.bfloat16: {"tokens": 0.995, "max": 2e-3, "mean": 1e-4, "early": 0.15}}
# The ARNN path on the card against the CPU, f32, H 64 (K7 against its plain
# version, the eager constraint LSTM on both): logits where the tokens agree.
ARNN_REF = {"tokens": 0.99, "logits": 1e-4}


def arnn_ops(rows: int, ticks: int, hidden: int, ctx: int, linear: int, vocab: int) -> float:
    """Multiply-adds x 2 of K7 per call: per row and tick, layer 0's (C, 4H)
    context and (H, 4H) recurrent products, layer 1's two (H, 4H) products,
    and the head's (H, L) and (L, V) products."""
    return 2.0 * rows * ticks * (4 * hidden * (ctx + 3 * hidden) + hidden * linear
                                 + linear * vocab)


def _arnn_inputs(model, params, batch: int, seed: int):
    """K7's inputs as the engine makes them: random tokens, the span's
    force mask, the position metadata and the constraint LSTM's outputs."""
    dev = torch.device("cuda")
    ticks = ARNN_BARS * 24
    rng = np.random.default_rng(seed)
    score = torch.from_numpy(rng.integers(0, VOCAB, (batch, ticks)).astype(np.int32)).to(dev)
    tick = torch.arange(ticks, device=dev)
    loc = ((tick < ARNN_START * 24) | (tick >= (ARNN_START + ARNN_SPAN) * 24)).to(torch.int32)
    loc = loc[None].expand(batch, -1).contiguous()
    md = np.stack([m.generate(ticks) for m in model.dataset.metadatas]
                  + [np.zeros(ticks, np.int64)], axis=1).astype(np.int32)
    md = torch.from_numpy(md).to(dev)[None].expand(batch, -1, -1)
    with torch.inference_mode():
        ctx, _ = model.output_lstm_constraints(params, model.embed_metadata(params, md, score, loc))
    return ctx, score, loc, model._start_embedding(params, 1)


def _agreement_line(a: dict) -> str:
    return (f"tokens equal {a['tokens']:.6f}, logits max_abs_err {a['logits_max']:.3e}, mean "
            f"{a['logits_mean']:.3e} where the fed-back tokens agree, tie gap "
            f"{a['tie_gap']:.3e}, forced mismatches {a['forced_mismatches']}, early logits "
            f"changed {a['early_changed']:.4f}")


ARNN_ROWS = (ARNN_BATCH, 64, 1)  # K7 bf16's rows: the engine's batch, a bucket, one request
# K7's bf16 Hopper route with noise of these scales added to the flagship's
# decode weights (their logits then spread, and order flips of bf16
# roundings show), at 64 rows x 384 ticks: held to the first kernel's
# readings on the same inputs, each against the plain version (max and
# mean at most ARNN_FIRST_RATIO times the first kernel's, its token share
# at least the first kernel's, the early share as ARNN_BOUNDS' or the first
# kernel's times the ratio); the two bf16 faults must break those bounds.
# The readings are in PERF.md.
ARNN_NOISE = (0.05, 0.1)
ARNN_FIRST_RATIO = 1.1


def _first_k7(ak, args):
    """K7's call through the first kernel (``csrc/arnn_decode.cu``)."""
    return ak._decode_tiled(*args, ak._check_arnn_args(*args))


def _noisy(tree, noise: float, gen):
    """``tree``'s tensors plus ``noise`` x N(0, 1), in their dtypes."""
    if isinstance(tree, dict):
        return {k: _noisy(v, noise, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_noisy(v, noise, gen) for v in tree)
    return (tree.float() + noise * torch.randn(tree.shape, generator=gen,
                                               device=tree.device)).to(tree.dtype)


def _k7_noisy_against_first_kernel(ak, model, params, card: str) -> None:
    """The bf16 Hopper route against the first kernel with noisy weights
    (``ARNN_NOISE``), and the planted faults against the same bounds."""
    _, ctx, score, force, start = (params, *_arnn_inputs(model, params, 64, seed=9))
    used = {k: params[k] for k in ("note_embedding", "lstm_generation", "linear_1",
                                   "linear_output_notes")}
    gen = torch.Generator(device="cuda").manual_seed(9)
    b = ARNN_BOUNDS[torch.bfloat16]
    for noise in ARNN_NOISE:
        args = (_noisy(used, noise, gen), ctx, score, force, start)
        got, first = ak.arnn_sampled_decode(*args), _first_k7(ak, args)
        want = ak.arnn_sampled_decode_reference(*args)
        a_got, a_first = (ak.decode_agreement(x, want, force) for x in (got, first))
        bounds = {"tokens": min(b["tokens"], a_first["tokens"]),
                  "max": ARNN_FIRST_RATIO * a_first["logits_max"],
                  "mean": ARNN_FIRST_RATIO * a_first["logits_mean"],
                  "early": max(b["early"], ARNN_FIRST_RATIO * a_first["early_changed"])}
        carry, projection = ak.carry_c, ak.ctx_projection
        ak.carry_c = lambda c, dtype: c
        try:
            faults = {"c carry kept in f32": ak.arnn_sampled_decode_reference(*args)}
        finally:
            ak.carry_c = carry
        ak.ctx_projection = lambda ctx, w: projection(ctx, w).to(torch.bfloat16).float()
        try:
            faults["context projection rounded to bf16"] = \
                ak.arnn_sampled_decode_staged_reference(*args)
        finally:
            ak.ctx_projection = projection
        print(f"[arnn-kernel] bf16 noise {noise}, 64 rows: Hopper route {_agreement_line(a_got)}; "
              f"first kernel {_agreement_line(a_first)} | {card}", flush=True)
        if not ak.within(a_got, bounds) or not bool(torch.isfinite(got[0].float()).all()):
            raise RuntimeError(f"K7's Hopper route is worse than the first kernel at noise {noise}")
        for name, planted in faults.items():
            f_agree = ak.decode_agreement(got, planted, force)
            print(f"[arnn-kernel] planted fault bf16 noise {noise}, {name}: "
                  f"{_agreement_line(f_agree)}", flush=True)
            if ak.within(f_agree, bounds):
                raise RuntimeError(f"a planted K7 fault passes at noise {noise}: {name}")


def _k7_by_cluster(ak, hidden, linear, call, dtype=torch.bfloat16):
    """{C: (K7's outputs, ms)} of ``call()`` with the dtype's K7 plan
    forced to each cluster size its geometry allows."""
    lp = ak.arnn_head_width(linear)
    if dtype == torch.float32:
        name, sizes = "arnn_f32_plan", ak.arnn_f32_cluster_sizes(hidden, lp)
    else:
        name, sizes = "arnn_plan", ak.arnn_cluster_sizes(hidden, lp)
    real, got = getattr(ak, name), {}
    for c in sizes:
        stages = 2 if dtype == torch.float32 else ak.arnn_ring_stages(
            hidden, c, ak.arnn_hid_cols(hidden, c, lp))
        setattr(ak, name, lambda *shape, c=c, st=stages: real(*shape)._replace(cluster=c,
                                                                                 stages=st))
        try:
            got[c] = (call(), cuda_ms(call, 5))
        finally:
            setattr(ak, name, real)
    return got


# K7's Hopper routes as torch.profiler names their kernels: the context
# projection GEMM and the recurrence, in bf16 and (split) in f32.
K7_PARTS = {torch.bfloat16: (("GEMM", "encoder_xw_gemm_split_kernel"),
                             ("recurrence", "arnn_kernel")),
            torch.float32: (("GEMM", "encoder_xw_gemm_split_kernel"),
                            ("recurrence", "arnn_f32_kernel"))}


def k7_parts(call, want: int, dtype=torch.bfloat16) -> tuple:
    """``torch.profiler``'s split of one K7 call: ({part: device ms}, CUDA
    launches of K7's kernels), traced again while fewer than ``want``
    launches show."""
    def count(trace):
        parts, launches = {}, 0
        for name, ms, n in trace[2]:
            for label, kernel in K7_PARTS[dtype]:
                if kernel in name:
                    parts[label] = parts.get(label, 0.0) + ms
                    launches += n
                    break
        return parts, launches
    return _profile_retaken(count, call, want)


def phase_arnn_kernel(model, card: str) -> dict:
    """K7 against its plain version at batch 512 x 384 ticks, flagship
    width, f32 and bf16; the planted faults; the times (bf16 reported, f32
    beside it). Both Hopper routes also at 64 and 1 rows, every cluster
    size bit-equal to the others (the cluster only moves h between its
    CTAs), their CUDA launches asserted, each timed beside the first kernel
    (f32 also beside both its bounds); bf16 with noisy weights against the
    first kernel (``ARNN_NOISE``)."""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    report = {}
    H, C = model.num_lstm_generation_units, model.num_lstm_constraints_units
    L = model.num_units_linear
    for dtype in (torch.float32, torch.bfloat16):
        params = cast_params(model.params(), "cuda", dtype)
        args = (params, *_arnn_inputs(model, params, ARNN_BATCH, seed=8))
        got = ak.arnn_sampled_decode(*args)
        agree = ak.decode_agreement(got, ak.arnn_sampled_decode_reference(*args), args[3])
        b = ARNN_BOUNDS[dtype]
        print(f"[arnn-kernel] {dtype} rows {ARNN_BATCH} ticks {ARNN_BARS * 24}: "
              f"{_agreement_line(agree)} (bounds {b})", flush=True)
        if not ak.within(agree, b) or not bool(torch.isfinite(got[0].float()).all()):
            raise RuntimeError(f"K7 disagrees with its plain version in {dtype}")
        faults = {}
        fm = args[3]
        faults["force mask read one tick late"] = ak.arnn_sampled_decode_reference(
            *args[:3], torch.cat([fm[:, :1], fm[:, :-1]], dim=1).contiguous(), args[4])
        carry, projection, product = ak.carry_c, ak.ctx_projection, ak.recurrent_product
        if dtype == torch.bfloat16:
            ak.carry_c = lambda c, dtype: c
            try:
                faults["c carry kept in f32"] = ak.arnn_sampled_decode_reference(*args)
            finally:
                ak.carry_c = carry
        else:
            ak.recurrent_product = lambda h, w: h.bfloat16().float() @ w
            try:
                faults["products on h as one bf16 piece"] = \
                    ak.arnn_sampled_decode_reference(*args)
            finally:
                ak.recurrent_product = product
        ak.ctx_projection = lambda ctx, w: projection(ctx, w).to(torch.bfloat16).float()
        try:
            faults["context projection rounded to bf16"] = \
                ak.arnn_sampled_decode_staged_reference(*args)
        finally:
            ak.ctx_projection = projection
        for name, planted in faults.items():
            f_agree = ak.decode_agreement(got, planted, fm)
            print(f"[arnn-kernel] planted fault {dtype}, {name}: {_agreement_line(f_agree)}",
                  flush=True)
            if ak.within(f_agree, b):
                raise RuntimeError(f"a planted K7 fault passes the {dtype} bounds: {name}")
        used = {k: params[k] for k in ("note_embedding", "lstm_generation", "linear_1",
                                       "linear_output_notes")}
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        if dtype == torch.bfloat16:
            _k7_noisy_against_first_kernel(ak, model, params, card)
        for rows in ARNN_ROWS:
            call_args = args if rows == ARNN_BATCH else (
                params, *_arnn_inputs(model, params, rows, seed=8))
            out = got if rows == ARNN_BATCH else ak.arnn_sampled_decode(*call_args)
            plan = (ak.arnn_card_plan if dtype == torch.bfloat16 else ak.arnn_f32_card_plan)(
                rows, H, L, args[1].device)
            by_c = _k7_by_cluster(ak, H, L, lambda: ak.arnn_sampled_decode(*call_args), dtype)
            same = all(torch.equal(o[0], out[0]) and torch.equal(o[1], out[1])
                       for o, _ in by_c.values())
            print(f"[arnn-kernel] {tag} rows {rows}: clusters {sorted(by_c)} bit-equal {same}",
                  flush=True)
            if not same:
                raise RuntimeError(f"K7 {tag} differs across cluster sizes at {rows} rows")
            ms = by_c[plan.cluster][1]
            want = ak.arnn_cuda_launches(dtype, rows, ARNN_BARS * 24, H, L, model.num_notes)
            parts, launches = k7_parts(lambda: ak.arnn_sampled_decode(*call_args), want, dtype)
            print(f"[arnn-kernel] {tag} rows {rows}: device " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in parts.items()) + f"; {launches} CUDA launches "
                f"({want} expected) | {card}", flush=True)
            if launches != want:
                raise RuntimeError(f"K7: {launches} CUDA launches at {rows} rows, expected {want}")
            plain_ms = cuda_ms(lambda: ak.arnn_sampled_decode_reference(*call_args), 2)
            ops = arnn_ops(rows, ARNN_BARS * 24, H, C, L, model.num_notes)
            moved = nbytes(used, *call_args[1:], *out)
            bound = bound_of(ops, kind, moved)
            extra = ""
            if dtype == torch.float32:  # the split products' bound, beside the FMA units'
                bound = {**bound_of(6 * ops, "bf16", moved), "bound_f32_fma_ms": bound["bound_ms"]}
                extra = f", f32 FMA bound {bound['bound_f32_fma_ms']:.4f} ms"
            per = ", ".join(f"cluster {c} {v[1]:.3f} ms" for c, v in by_c.items())
            first_ms = cuda_ms(lambda: _first_k7(ak, call_args), 3)
            print(f"[time] arnn_sampled_decode {dtype} rows {rows}: kernel {ms:.3f} ms "
                  f"(cluster {plan.cluster}, stages {plan.stages}; {per}), first kernel "
                  f"{first_ms:.3f} ms, plain {plain_ms:.3f} "
                  f"ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}){extra} | {card}",
                  flush=True)
            if rows == ARNN_BATCH:
                entry = {"max_abs_err": agree["logits_max"], "ms": ms, "plain_ms": plain_ms,
                         **bound, "library_ms": None}
                if dtype == torch.float32:
                    f32_entry = entry
                else:
                    report["arnn_sampled_decode"] = {**entry, "f32": f32_entry}
    return report


def phase_arnn_reference(vocab: int = VOCAB, hidden: int = 64, ctx: int = 64):
    """The ARNN path on the card (K7) against the same model on the CPU
    (plain versions), f32, generation LSTM H ``hidden`` and constraint
    LSTM C ``ctx`` (64 each, or narrow ones that run on zero units), a
    vocabulary of ``vocab``: the argmax
    inpaint and a sampled generate with per-row keys (the same noise bits on
    both devices)."""
    from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
    from inpaintnet_tpu_torch.models.presets import ARNNDataset
    from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_sampled_decode

    batch, ticks = 4, 8 * 24
    rng = np.random.default_rng(9)
    arrays = (rng.integers(0, VOCAB, (batch, ticks)).astype(np.int32),
              np.stack([np.stack([m.generate(ticks) for m in ARNNDataset().metadatas]
                                 + [np.zeros(ticks, np.int64)], 1)] * batch).astype(np.int32),
              ((np.arange(ticks) < 72) | (np.arange(ticks) >= 120))[None].repeat(batch, 0)
              .astype(np.int32))
    keys = rng.integers(0, 2**32, (batch, 2))
    out = {}
    before = arnn_sampled_decode.launches
    for dev in ("cuda", "cpu"):
        model = AnticipationRNNBaseline(
            ARNNDataset(vocab_size=vocab), note_embedding_dim=10, metadata_embedding_dim=2,
            num_lstm_constraints_units=ctx, num_lstm_generation_units=hidden,
            linear_hidden_size=64, num_layers=2, unary_constraint=True, device=dev, seed=3)
        score, md, loc = (torch.from_numpy(a).to(dev) for a in arrays)
        with torch.inference_mode():
            lg, tok = model.apply_inpaint(model.params(), score, md, loc)
            _, sampled = model.generate(model.params(), score, md, loc, temperature=1.5,
                                        row_keys=torch.from_numpy(keys).to(dev))
        out[dev] = (lg.cpu(), tok.cpu(), sampled.cpu())
    if arnn_sampled_decode.launches != before + 1:
        raise RuntimeError("the ARNN inpaint on the card did not launch K7 once")
    (lg, tok, smp), (lg_c, tok_c, smp_c) = out["cuda"], out["cpu"]
    share = (tok == tok_c).float().mean().item()
    err = (lg - lg_c).abs()[_first_divergence_mask(tok, tok_c)].max().item()
    print(f"[arnn-reference] f32 H {hidden} C {ctx} V {vocab}, card (K7) vs CPU plain: "
          f"inpaint tokens equal "
          f"{share:.4f} "
          f"(bound {ARNN_REF['tokens']}), logits max_abs_err {err:.3e} (bound "
          f"{ARNN_REF['logits']:.0e}); sampled tokens equal {(smp == smp_c).float().mean():.4f} "
          f"(printed, no limit)", flush=True)
    if share < ARNN_REF["tokens"] or err > ARNN_REF["logits"]:
        raise RuntimeError("the ARNN path on the card disagrees with the CPU")


def _arnn_request(rng, batch: int, measures: int):
    return rng.integers(0, VOCAB, (batch, measures, 24)).astype(np.int32)


def phase_arnn_engine(model, card: str):
    """The bf16 ARNN engine at flagship width serves batch 512 x 16 bars with
    a 4-measure span and a batch-1 request (checked; K7 must launch), then
    the times and one profiled call of each. -> (engine, {kernel: launches})"""
    from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_sampled_decode
    from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

    engine = ARNNServingEngine(model, batch_buckets=ARNN_BUCKETS, dtype="bfloat16",
                               device="cuda")
    engine.warmup(ARNN_BARS)
    rng = np.random.default_rng(10)
    big = _arnn_request(rng, ARNN_BATCH, ARNN_BARS)
    one = _arnn_request(rng, 1, ARNN_BARS)
    requests = [(f"batch {ARNN_BATCH}", big), ("batch 1", one)]

    def serve():
        for label, tokens in requests:
            out = engine.inpaint(tokens, ARNN_START, ARNN_SPAN)
            _check_response(out, tokens, ARNN_START, ARNN_SPAN)
            if not np.array_equal(out, engine.inpaint(tokens, ARNN_START, ARNN_SPAN)):
                raise RuntimeError(f"ARNN {label}: the argmax decode is not deterministic")
            span = slice(ARNN_START, ARNN_START + ARNN_SPAN)
            sampled = engine.inpaint(tokens, ARNN_START, ARNN_SPAN, seed=3, temperature=1.5)
            _check_response(sampled, tokens, ARNN_START, ARNN_SPAN)
            print(f"[arnn-engine] bf16 {label} x {ARNN_BARS} bars, span {ARNN_SPAN}: ok; "
                  f"{(out[:, span] != tokens[:, span]).mean():.3f} of argmax and "
                  f"{(sampled[:, span] != tokens[:, span]).mean():.3f} of sampled span tokens "
                  f"differ from the input", flush=True)

    _, launches = _launches_during([arnn_sampled_decode], serve)
    print(f"[arnn-engine] K7 launches during the requests: {launches}", flush=True)

    t_big = cuda_ms(lambda: engine.inpaint(big, ARNN_START, ARNN_SPAN), 5)
    lat = [cuda_ms(lambda: engine.inpaint(one, ARNN_START, ARNN_SPAN), 1) for _ in range(20)]
    route = _route_name(engine)
    print(f"[time] arnn engine bf16 ({route}) batch {ARNN_BATCH} x {ARNN_BARS} bars, span "
          f"{ARNN_SPAN}: {t_big:.2f} ms per call, {ARNN_BATCH * ARNN_SPAN / (t_big / 1e3):.1f} "
          f"span-measures/s | {card}", flush=True)
    print(f"[time] arnn engine bf16 ({route}) batch 1: p50 {np.median(lat):.2f} ms (p90 "
          f"{np.percentile(lat, 90):.2f} ms) | {card}", flush=True)
    for label, tokens, wall in ((f"batch {ARNN_BATCH}", big, t_big),
                                ("batch 1", one, float(np.median(lat)))):
        _profile_line(f"arnn bf16 ({route}) {label}",
                      lambda: engine.inpaint(tokens, ARNN_START, ARNN_SPAN), wall, card)
    return engine, launches


def phase_arnn_http(main_engine, engine, card: str) -> dict:
    """The port's HTTP server with the ARNN engine, dynamic batching pinned
    to bucket 64: concurrent ``/v1/arnn/inpaint`` clients, argmax and
    sampled, must equal the engine's solo ``inpaint_hetero``; K7 must
    launch."""
    from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_sampled_decode
    from inpaintnet_tpu_torch.server import InpaintingServer

    pin = 64
    rng = np.random.default_rng(12)
    reqs = []
    for i in range(16):
        m = int(rng.integers(13, ARNN_BARS + 1)) if i % 4 else 8
        num = int(rng.integers(1, min(4, m - 1) + 1))
        req = {"tokens": _arnn_request(rng, int(rng.integers(1, 4)), m),
               "start_measure": int(rng.integers(1, m - num + 1)), "num_measures": num}
        if i % 2:
            req.update(temperature=float(rng.uniform(0.5, 2.0)), seed=2000 + i)
        reqs.append(req)
    server = InpaintingServer(main_engine, port=0, batching=True, pin_bucket=pin,
                              arnn_engine=engine)
    port = server.start()
    try:
        (results, wall), launches = _launches_during(
            [arnn_sampled_decode], lambda: _burst(port, "/v1/arnn/inpaint", reqs, "tokens"))
        health = _http(port, "GET", "/healthz")
        for req, got in zip(reqs, results):
            want = engine.inpaint_hetero([req], bucket=pin)[0]
            if not np.array_equal(got, want):
                raise RuntimeError("an /v1/arnn/inpaint response differs from the solo "
                                   f"inpaint_hetero ({'sampled' if 'seed' in req else 'argmax'})")
        meta = _http(port, "GET", "/v1/meta")
        if meta["arnn"]["model"] != "AnticipationRNNBaseline":
            raise RuntimeError(f"/v1/meta: {meta}")
        print(f"[arnn-http] {len(reqs)} concurrent /v1/arnn/inpaint (argmax and sampled, 8 and "
              f"13-16 bars): every response equals the solo inpaint_hetero at bucket {pin}; "
              f"{health['arnn_batching']['calls']} coalesced device calls; {wall * 1e3:.1f} ms "
              f"wall; launches {launches} | {card}", flush=True)
    finally:
        server.stop()
    return launches

# ---------------------------------------------------------------------------
# Phase 24: the heads of K2, K4 and K7 over wider vocabularies and heads
# ---------------------------------------------------------------------------
HEAD_VOCABS = (97, 256)  # K2 and K4: past one 96-column head chunk, and three chunks
ARNN_HEAD_VOCABS = (90, 256)  # K7: past one 64-column output chunk, and four chunks
# K7 beside the flagship's widths, at the engine's batch: (H, C, linear, V,
# dtypes). H = C = 512 with a 256-wide head: in bf16 a 128-column hidden
# tile in two rounds; a 1,024-wide head: rounds of 512 in bf16. The first
# kernel, which ran them before, is timed beside and is the yardstick of
# bf16's early share.
ARNN_WIDE = ((512, 512, 256, 60, (torch.bfloat16,)),
             (256, 256, 1024, 90, (torch.bfloat16, torch.float32)))
# K7 at the wider heads against its plain version: ARNN_BOUNDS, but a bf16
# token share of 0.95. A head of V drawn anew on random weights has
# near-flat logits, and the more columns, the more argmax near-ties whose
# rounding flips cascade over a row's 384 ticks: seen on an NVIDIA H100
# 80GB HBM3 (700 W) tokens 0.99295 at V 90 (512 rows) and 0.97892 at V 256
# (64 rows), every row's first mismatch within 3.1e-5 of its top logit,
# logits max 6.1e-5, mean 2.6e-6, early share 0.024-0.033. The max, the
# mean, the tie gap (each first mismatch a near-tie), no mismatch at a
# forced tick and the early share, which the planted faults break, are
# ARNN_BOUNDS'.
ARNN_HEAD_BOUNDS = {torch.float32: ARNN_BOUNDS[torch.float32],
                    torch.bfloat16: {**ARNN_BOUNDS[torch.bfloat16], "tokens": 0.95}}
# The V 256 engines and the V 90 ARNN engine: their buckets (captured on
# the first call of each)
VOCAB_BUCKETS = (1, BATCH)
VOCAB_ARNN_BUCKETS = (1, ARNN_BATCH)
ENGINE_VOCAB, ARNN_ENGINE_VOCAB = 256, 90  # the engines' vocabularies


def _head_params(tree: dict, head: str, table: str, rows: int, vocab: int, seed: int) -> dict:
    """``tree`` (the flagship's params, on the card) with a ``vocab``-column
    head (``tree[head]``: linear_init's scale) and a ``rows``-row embedding
    ``tree[table]`` (embedding_init's), drawn from ``seed``."""
    from inpaintnet_tpu_torch.ops.linear import embedding_init, linear_init

    rng = np.random.default_rng(seed)
    w = tree[head]["w"]
    dev, dtype = w.device, w.dtype
    lin = linear_init(rng, w.shape[0], vocab)
    emb = embedding_init(rng, rows, tree[table]["table"].shape[1])["table"]
    return {**tree, head: {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev, dtype)
                           for k, v in lin.items()},
            table: {"table": torch.from_numpy(np.asarray(emb, np.float32)).to(dev, dtype)}}


def _tied(tree: dict, head: str, width: int, col: int = 5) -> dict:
    """``tree`` with head column ``col`` copied into the next chunk (``col +
    width``) and both biases raised by 8: equal logits, every tick's
    largest, on either side of a chunk border."""
    w, b = tree[head]["w"].clone(), tree[head]["b"].clone()
    w[:, col + width] = w[:, col]
    b[col] += 8.0
    b[col + width] = b[col]
    return {**tree, head: {**tree[head], "w": w, "b": b}}


@contextlib.contextmanager
def _later_chunk_wins_ties():
    """The heads' planted fault inside the block: a later chunk wins a tie
    (``kernel_common.head_ties``, passed to every launch)."""
    from inpaintnet_tpu_torch.ops import kernel_common

    real = kernel_common.head_ties
    kernel_common.head_ties = lambda: 1
    try:
        yield
    finally:
        kernel_common.head_ties = real


def _decoder_inputs(vae, dtype, rows: int, seed: int):
    """The decoder's params in ``dtype`` and K2's per-beat inputs of
    ``rows`` random z, as the engine makes them."""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.models.measure_vae import NUM_BEATS_PER_MEASURE
    from inpaintnet_tpu_torch.ops.linear import linear_apply

    dec = cast_params(vae.params(), "cuda", dtype)["decoder"]
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((rows, vae.latent_space_dim)).astype(np.float32))
    with torch.inference_mode():
        beat_out = vae.decoder._beat_outputs(dec, z.to("cuda", dtype))
        tick_ctx = torch.selu(linear_apply(dec["beat_to_tick_input"], beat_out)).contiguous()
        h_inits = vae.decoder._tick_h0(
            dec, beat_out.reshape(rows * NUM_BEATS_PER_MEASURE, -1)
        ).reshape(2, rows, NUM_BEATS_PER_MEASURE, -1).contiguous()
    return dec, tick_ctx, h_inits


def _k2_k4_heads(vae, card: str) -> dict:
    """K2 (bf16, f32) and K4 (bf16 and f32 masters) at ``HEAD_VOCABS`` on
    the flagship decoder (H 512, a head and token table of V drawn anew) at
    ``DECODE_ROWS``: against the plain versions (``BOUNDS``; K4 bit-equal),
    one launch a call, timed beside the same call at V 60; then the tie
    across a head chunk border, and its planted fault. -> {kernel: {"V 97":
    entry, ...}} at 12,288 rows."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk

    cases = (("decode_sampling", torch.bfloat16, dk.decode_sampling,
              dk.decode_sampling_reference, BOUNDS[torch.bfloat16], "bf16"),
             ("decode_sampling", torch.float32, dk.decode_sampling,
              dk.decode_sampling_reference, BOUNDS[torch.float32], "f32"),
             ("decode_sampling_int8", torch.bfloat16, dk.decode_sampling_int8,
              dk.decode_sampling_int8_reference, BOUNDS_INT8, "int8"),
             ("decode_sampling_int8", torch.float32, dk.decode_sampling_int8,
              dk.decode_sampling_int8_reference, BOUNDS_INT8, "int8"))
    report = {}
    for name, dtype, kernel, plain, bound, kind in cases:
        label = f"{name} {str(dtype)[6:]}{' masters' if name.endswith('int8') else ''}"
        dec60, tick_ctx, h_inits = _decoder_inputs(vae, dtype, DECODE_ROWS[0], seed=24)
        hidden = tick_ctx.shape[2]
        for vocab in HEAD_VOCABS:
            dec = _head_params(dec60, "head", "embedding", vocab, vocab, seed=vocab)
            used = {k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")}
            for rows in DECODE_ROWS:
                tc, hi = tick_ctx[:rows].contiguous(), h_inits[:, :rows].contiguous()
                before = kernel.launches
                got = kernel(dec, tc, hi)
                want = plain(dec, tc, hi)
                torch.cuda.synchronize()
                agree = dk.agreement(got, want)
                ok = (bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
                      if bound is BOUNDS_INT8 else dk.within(agree, bound))
                print(f"[heads] {label} V {vocab} rows {rows}: {agree} (bounds {bound}), "
                      f"{kernel.launches - before} launch", flush=True)
                if not ok or kernel.launches != before + 1 or got[0].shape[2] != vocab:
                    raise RuntimeError(f"{label} at V {vocab}, {rows} rows disagrees with its "
                                       "plain version or did not launch once")
                if rows != DECODE_ROWS[0]:
                    continue
                ms = cuda_ms(lambda: kernel(dec, tc, hi), 5)
                ms60 = cuda_ms(lambda: kernel(dec60, tc, hi), 5)
                b = bound_of(decode_ops(rows, hidden, vocab), kind, nbytes(used, tc, hi, *got))
                entry = {"max_abs_err": agree["logits"], "ms": ms, "ms_v60": ms60,
                         "plain_ms": cuda_ms(lambda: plain(dec, tc, hi), 2), **b,
                         "library_ms": None, "launches": 1}
                report.setdefault(label, {})[f"V {vocab}"] = entry
                print(f"[time] {label} V {vocab} rows {rows}: kernel {ms:.3f} ms, at V 60 "
                      f"{ms60:.3f} ms ({ms / ms60:.3f}x), plain {entry['plain_ms']:.3f} ms, "
                      f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) | {card}", flush=True)
        # the tie across the first head chunk border, and its planted fault
        dec = _tied(_head_params(dec60, "head", "embedding", 256, 256, seed=7), "head",
                    dk.HEAD_COLS)
        tc, hi = tick_ctx[:70].contiguous(), h_inits[:, :70].contiguous()
        want = plain(dec, tc, hi)[1]
        got = kernel(dec, tc, hi)[1]
        with _later_chunk_wins_ties():
            fault = kernel(dec, tc, hi)[1]
        torch.cuda.synchronize()
        print(f"[heads] {label} tie across the chunk border: plain tokens all 5 "
              f"{bool((want == 5).all())}, kernel equal {bool(torch.equal(got, want))}; planted "
              f"fault (the later chunk wins ties) equal {bool(torch.equal(fault, want))}",
              flush=True)
        if not ((want == 5).all() and torch.equal(got, want)) or torch.equal(fault, want):
            raise RuntimeError(f"{label}: the chunk-border tie is not taken by the first index, "
                               "or its planted fault passes")
    return report


def _k7_check(ak, args, bound, label: str, card: str, time_it: bool):
    """One K7 call against its plain version within ``bound``: one wrapper
    launch, two CUDA launches a chunk of rows (``arnn_cuda_launches``) and
    none of the first kernel (``arnn_decode_kernel``) in a trace (taken
    again, up to twice, while it shows fewer). -> (its agreement, ms or
    None, the call's outputs)"""
    params, ctx = args[0], args[1]
    dtype = params["lstm_generation"][0]["w_hh"].dtype
    linear, vocab = params["linear_output_notes"]["w"].shape
    hidden = params["lstm_generation"][0]["w_hh"].shape[0]
    rows, ticks = ctx.shape[0], ctx.shape[1]
    before = ak.arnn_sampled_decode.launches
    got = ak.arnn_sampled_decode(*args)
    once = ak.arnn_sampled_decode.launches == before + 1
    want = ak.arnn_sampled_decode_reference(*args)
    torch.cuda.synchronize()
    agree = ak.decode_agreement(got, want, args[3])
    expect = ak.arnn_cuda_launches(dtype, rows, ticks, hidden, linear, vocab)
    own = _own_kernels(lambda: ak.arnn_sampled_decode(*args), want=expect)
    recurrence = "arnn_kernel" if dtype == torch.bfloat16 else "arnn_f32_kernel"
    print(f"[heads] arnn_sampled_decode {label}: {_agreement_line(agree)} (bounds {bound}); CUDA "
          f"launches {own} ({expect} expected) | {card}", flush=True)
    faults = [why for why, bad in (
        ("the wrapper did not count one launch", not once),
        (f"outside its bounds {bound}: {_agreement_line(agree)}", not ak.within(agree, bound)),
        (f"traced CUDA launches {own}, {expect} expected with {expect // 2} of {recurrence} "
         f"(lead kernels the traces so far lost: {LEADS_LOST[0]} of {LEADS_LOST[1]})",
         sum(own.values()) != expect or own.get(recurrence, 0) != expect // 2),
        ("the first kernel arnn_decode_kernel launched", "arnn_decode_kernel" in own),
        (f"logits of {got[0].shape[2]} columns", got[0].shape[2] != vocab)) if bad]
    if faults:
        raise RuntimeError(f"K7 {label}: " + "; ".join(faults))
    return agree, (cuda_ms(lambda: ak.arnn_sampled_decode(*args), 3) if time_it else None), got


def _k7_heads(arnn, card: str) -> dict:
    """K7 (bf16, f32) at ``ARNN_HEAD_VOCABS`` on the flagship (H = C = L =
    256, a head and token table of V drawn anew) at ``ARNN_ROWS`` x 384
    ticks, at the ``ARNN_WIDE`` geometries, each against its plain version
    with two CUDA launches a chunk and none of the first kernel, timed beside
    V 60 at 512 rows; the tie across an output chunk border and its planted
    fault. -> {dtype label: {"V 90": entry, ...}}"""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda_kernels import _arnn_case

    H, C, L = (arnn.num_lstm_generation_units, arnn.num_lstm_constraints_units,
               arnn.num_units_linear)
    report = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        p60 = cast_params(arnn.params(), "cuda", dtype)
        bound = ARNN_HEAD_BOUNDS[dtype]
        inputs = {rows: _arnn_inputs(arnn, p60, rows, seed=24) for rows in ARNN_ROWS}
        for vocab in ARNN_HEAD_VOCABS:
            params = _head_params(p60, "linear_output_notes", "note_embedding", vocab + 1,
                                  vocab, seed=vocab)
            start = params["note_embedding"]["table"][vocab:].contiguous()
            used = {k: params[k] for k in ("note_embedding", "lstm_generation", "linear_1",
                                           "linear_output_notes")}
            for rows in ARNN_ROWS:
                ctx, score, force, _ = inputs[rows]
                args = (params, ctx, score, force, start)
                agree, ms, got = _k7_check(ak, args, bound, f"{tag} V {vocab} rows {rows}",
                                           card, rows == ARNN_BATCH)
                if ms is None:
                    continue
                ms60 = cuda_ms(lambda: ak.arnn_sampled_decode(p60, ctx, score, force,
                                                              inputs[rows][3]), 3)
                ops = arnn_ops(rows, ARNN_BARS * 24, H, C, L, vocab)
                moved = nbytes(used, *args[1:], *got)
                b = (bound_of(ops, "bf16", moved) if dtype == torch.bfloat16
                     else {**bound_of(6 * ops, "bf16", moved),
                           "bound_f32_fma_ms": bound_of(ops, "f32", moved)["bound_ms"]})
                entry = {"max_abs_err": agree["logits_max"], "ms": ms, "ms_v60": ms60,
                         "plain_ms": cuda_ms(lambda: ak.arnn_sampled_decode_reference(*args), 1),
                         **b, "library_ms": None,
                         "launches": ak.arnn_cuda_launches(dtype, rows, ARNN_BARS * 24, H, L,
                                                           vocab)}
                report.setdefault(tag, {})[f"V {vocab}"] = entry
                print(f"[time] arnn_sampled_decode {tag} V {vocab} rows {rows}: kernel {ms:.3f} "
                      f"ms, at V 60 {ms60:.3f} ms ({ms / ms60:.3f}x), plain "
                      f"{entry['plain_ms']:.3f} ms, bound {b['bound_ms']:.4f} ms "
                      f"({b['bound_by']}) | {card}", flush=True)
        # the tie across the first output chunk border, and its planted fault
        params = _tied(_head_params(p60, "linear_output_notes", "note_embedding", 131, 130,
                                    seed=7), "linear_output_notes", ak.ARNN_OUT_COLS)
        ctx, score, force, _ = inputs[64]
        args = (params, ctx, score, force, params["note_embedding"]["table"][130:].contiguous())
        free = force == 0
        want = ak.arnn_sampled_decode_reference(*args)[1]
        got = ak.arnn_sampled_decode(*args)[1]
        with _later_chunk_wins_ties():
            fault = ak.arnn_sampled_decode(*args)[1]
        torch.cuda.synchronize()
        print(f"[heads] arnn_sampled_decode {tag} tie across the chunk border: plain sampled "
              f"tokens all 5 {bool((want[free] == 5).all())}, kernel equal "
              f"{bool(torch.equal(got, want))}; planted fault (the later chunk wins ties) equal "
              f"{bool(torch.equal(fault, want))}", flush=True)
        if not ((want[free] == 5).all() and torch.equal(got, want)) or torch.equal(fault, want):
            raise RuntimeError(f"K7 {tag}: the chunk-border tie is not taken by the first index, "
                               "or its planted fault passes")
    for hidden, ctx_dim, linear, vocab, dtypes in ARNN_WIDE:
        for dtype in dtypes:
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            args = _arnn_case(np.random.default_rng(hidden + linear), ARNN_BATCH, hidden,
                              ctx_dim, ARNN_BARS * 24, vocab, linear, dtype, "cuda", noise=0.0)
            label = f"{tag} H {hidden} C {ctx_dim} head {linear} x {vocab}"
            # the first kernel, which ran these geometries before, on the same
            # inputs: at H 512 more bf16 roundings flip in the first ticks, and
            # the early share is held to its reading as phase 12's noisy
            # weights are (ARNN_FIRST_RATIO)
            first = _first_k7(ak, args)
            a_first = ak.decode_agreement(first, ak.arnn_sampled_decode_reference(*args), args[3])
            first_ms = cuda_ms(lambda: _first_k7(ak, args), 3)
            bound = dict(ARNN_HEAD_BOUNDS[dtype])
            if dtype == torch.bfloat16:
                bound["early"] = max(bound["early"], ARNN_FIRST_RATIO * a_first["early_changed"])
            print(f"[heads] arnn_sampled_decode {label} rows {ARNN_BATCH}, the first kernel: "
                  f"{_agreement_line(a_first)}, {first_ms:.3f} ms | {card}", flush=True)
            agree, ms, got = _k7_check(ak, args, bound, f"{label} rows {ARNN_BATCH}", card, True)
            plan = (ak.arnn_card_plan if dtype == torch.bfloat16 else ak.arnn_f32_card_plan)(
                ARNN_BATCH, hidden, linear, args[1].device)
            ht = ak.arnn_hid_cols(hidden, plan.cluster, ak.arnn_head_width(linear))
            ops = arnn_ops(ARNN_BATCH, ARNN_BARS * 24, hidden, ctx_dim, linear, vocab)
            moved = nbytes({k: args[0][k] for k in ("note_embedding", "lstm_generation",
                                                    "linear_1", "linear_output_notes")},
                           *args[1:], *got)
            b = bound_of(ops if dtype == torch.bfloat16 else 6 * ops, "bf16", moved)
            entry = {"max_abs_err": agree["logits_max"], "ms": ms, "first_kernel_ms": first_ms,
                     "plain_ms": cuda_ms(lambda: ak.arnn_sampled_decode_reference(*args), 1), **b,
                     "library_ms": None, "launches": 2, "cluster": plan.cluster}
            report.setdefault(tag, {})[f"H {hidden} head {linear} V {vocab}"] = entry
            print(f"[time] arnn_sampled_decode {label} rows {ARNN_BATCH}: kernel {ms:.3f} ms "
                  f"(cluster {plan.cluster}, stages {plan.stages}"
                  f"{f', hidden tile {ht}' if dtype == torch.bfloat16 else ''}), the first "
                  f"kernel {first_ms:.3f} ms, plain {entry['plain_ms']:.3f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}) | {card}", flush=True)
    return report


def _vocab_latent_engines(card: str) -> dict:
    """The LatentRNN flagship at V 256: its main path on the card against
    the CPU (f32, phase 5's check), then the bf16 engine (on the ``"xla"``
    GRU route) and the int8 engine on the graph route at batch 2048 (6/4/6)
    and batch 1, checked, K2 / K4 launches counted, measures/s, the batch-1
    p50 and the decode kernel's device ms. -> {kernel: launches}"""
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    _, _, model = build_flagship(vocab_size=ENGINE_VOCAB, seed=0, device="cuda",
                                 dtype=torch.float32)
    phase_reference(model, quantized=False)
    rng = np.random.default_rng(24)
    big = _request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE)
    one = _request(rng, 1, 7, 2, 7)
    launches = {}
    for dtype, key in (("bfloat16", "rec90::decode_kernel<"), ("int8", "decode_i8_kernel<")):
        engine = InpaintingEngine(model, batch_buckets=VOCAB_BUCKETS, dtype=dtype, device="cuda")

        def serve():
            for tokens, start, num in (big, one):
                out = engine.inpaint(tokens, start, num, seed=11)
                _check_response(out, tokens, start, num, vocab=ENGINE_VOCAB)
                if not np.array_equal(out, engine.inpaint(tokens, start, num, seed=11)):
                    raise RuntimeError(f"V {ENGINE_VOCAB} {dtype} engine: the same seed gave "
                                       "other tokens")

        _, counts = _launches_during(_kernels_of(dtype), serve)
        launches.update(counts)
        t_big = cuda_ms(lambda: engine.inpaint(*big, seed=5), 5)
        lat = [cuda_ms(lambda: engine.inpaint(*one, seed=5), 1) for _ in range(20)]
        dev_big = _device_ms(lambda: engine.inpaint(*big, seed=5), key)
        dev_one = _device_ms(lambda: engine.inpaint(*one, seed=5), key)
        print(f"[engine] V {ENGINE_VOCAB} {dtype} ({_route_name(engine)}): ok, launches {counts}; "
              f"batch {BATCH} 6/4/6 {t_big:.2f} ms per call, "
              f"{BATCH * N_TARGET / (t_big / 1e3):.1f} "
              f"measures/s, the decode kernel {dev_big:.3f} ms device; batch 1 p50 "
              f"{np.median(lat):.2f} ms (p90 {np.percentile(lat, 90):.2f} ms), the decode kernel "
              f"{dev_one:.3f} ms device | {card}", flush=True)
        del engine
    return launches


def _vocab_arnn_engine(card: str) -> dict:
    """The ARNN at V 90: its path on the card against the CPU (f32, H 64,
    phase 12's check), then the flagship-width bf16 engine on the graph
    route at batch 512 and 1 (argmax), checked, K7 launches counted,
    span-measures/s, the batch-1 p50 and K7's device ms. -> {kernel:
    launches}"""
    from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
    from inpaintnet_tpu_torch.models.presets import ARNNDataset
    from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_sampled_decode
    from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

    phase_arnn_reference(vocab=ARNN_ENGINE_VOCAB)
    model = AnticipationRNNBaseline(
        ARNNDataset(vocab_size=ARNN_ENGINE_VOCAB), note_embedding_dim=10, metadata_embedding_dim=2,
        num_lstm_constraints_units=256, num_lstm_generation_units=256, linear_hidden_size=256,
        num_layers=2, unary_constraint=True, device="cuda", seed=0)
    engine = ARNNServingEngine(model, batch_buckets=VOCAB_ARNN_BUCKETS, dtype="bfloat16",
                               device="cuda")
    rng = np.random.default_rng(25)
    big, one = _arnn_request(rng, ARNN_BATCH, ARNN_BARS), _arnn_request(rng, 1, ARNN_BARS)

    def serve():
        for tokens in (big, one):
            out = engine.inpaint(tokens, ARNN_START, ARNN_SPAN)
            _check_response(out, tokens, ARNN_START, ARNN_SPAN, vocab=ARNN_ENGINE_VOCAB)
            if not np.array_equal(out, engine.inpaint(tokens, ARNN_START, ARNN_SPAN)):
                raise RuntimeError(f"V {ARNN_ENGINE_VOCAB} ARNN engine: the argmax decode is not "
                                   "deterministic")

    _, launches = _launches_during([arnn_sampled_decode], serve)
    t_big = cuda_ms(lambda: engine.inpaint(big, ARNN_START, ARNN_SPAN), 5)
    lat = [cuda_ms(lambda: engine.inpaint(one, ARNN_START, ARNN_SPAN), 1) for _ in range(20)]
    dev_big = _device_ms(lambda: engine.inpaint(big, ARNN_START, ARNN_SPAN), "arnn_kernel")
    dev_one = _device_ms(lambda: engine.inpaint(one, ARNN_START, ARNN_SPAN), "arnn_kernel")
    print(f"[arnn-engine] V {ARNN_ENGINE_VOCAB} bf16 ({_route_name(engine)}): ok, launches "
          f"{launches}; batch {ARNN_BATCH} x {ARNN_BARS} bars, span {ARNN_SPAN}: {t_big:.2f} ms "
          f"per call, "
          f"{ARNN_BATCH * ARNN_SPAN / (t_big / 1e3):.1f} span-measures/s, K7's recurrence "
          f"{dev_big:.3f} ms device; batch 1 p50 {np.median(lat):.2f} ms (p90 "
          f"{np.percentile(lat, 90):.2f} ms), K7's recurrence {dev_one:.3f} ms device | {card}",
          flush=True)
    return launches


def phase_vocab_heads(vae, arnn, card: str) -> tuple:
    """Phase 24: the heads over wider vocabularies and heads. -> ({kernel
    name: {case: entry}} for the kernels line, {kernel: launches} of the
    V 256 and V 90 engines' requests)"""
    t0 = time.perf_counter()
    heads = _k2_k4_heads(vae, card)
    k7 = _k7_heads(arnn, card)
    launches = {**_vocab_latent_engines(card), **_vocab_arnn_engine(card)}
    print(f"[heads] phase 24 took {time.perf_counter() - t0:.1f} s", flush=True)
    entries = {"decode_sampling": {"bf16": heads["decode_sampling bfloat16"],
                                   "f32": heads["decode_sampling float32"]},
               "decode_sampling_int8": {"bf16 masters": heads["decode_sampling_int8 bfloat16 "
                                                                "masters"],
                                        "f32 masters": heads["decode_sampling_int8 float32 "
                                                               "masters"]},
               "arnn_sampled_decode": k7}
    return entries, launches


# ---------------------------------------------------------------------------
# ``--parent DIR``: the flagship's V 60 decode kernels of an earlier
# checkout, timed beside this tree's in the same run
# ---------------------------------------------------------------------------
def kernel_times(root: str) -> dict:
    """Median ms of the flagship-shape decode kernels at V 60 through the
    wrappers of the checkout at ``root`` (its package imported, its kernels
    built into its own ``build/``): K2 and K4 (bf16 and f32 masters) at
    ``DECODE_ROWS``, K7 at ``ARNN_ROWS`` x 384 ticks, both dtypes, on its
    card tests' inputs (``_decode_case``, ``_arnn_case``)."""
    sys.path[:0] = [root, str(Path(root) / "tests")]
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops.kernel_common import build_kernels
    from test_torch_cuda_kernels import _arnn_case, _decode_case

    build_kernels()
    times = {"source": str(Path(dk.__file__).resolve())}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for rows in DECODE_ROWS:
            p, tc, hi = _decode_case(np.random.default_rng(1), rows, 512, VOCAB, dtype, "cuda")
            times[f"K2 {tag} {rows}"] = cuda_ms(lambda: dk.decode_sampling(p, tc, hi), 10)
            times[f"K4 {tag} {rows}"] = cuda_ms(lambda: dk.decode_sampling_int8(p, tc, hi), 10)
        for rows in ARNN_ROWS:
            args = _arnn_case(np.random.default_rng(1), rows, 256, 256, ARNN_BARS * 24, VOCAB,
                              256, dtype, "cuda", noise=0.0)
            times[f"K7 {tag} {rows}"] = cuda_ms(lambda: ak.arnn_sampled_decode(*args), 5)
    return times


def _child_times(out, root: str) -> dict:
    """The JSON line of a child process run on the checkout at ``root``,
    checked to have imported that checkout's package (its ``source``)."""
    times = json.loads(out.stdout.strip().splitlines()[-1])
    if not Path(times["source"]).is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"the run on {root} imported {times['source']}")
    return times


def phase_parent_times(parent: str, card: str) -> None:
    """The V 60 kernel times of ``parent`` and of this tree, each in a
    process of its own, in turns (parent, this, this, parent)."""
    here = str(Path(__file__).resolve().parent)
    runs = []
    for root in (parent, here, here, parent):
        out = subprocess.run([sys.executable, __file__, "--kernel-times", root],
                             capture_output=True, text=True, timeout=900, cwd=root)
        if out.returncode != 0:
            raise RuntimeError(f"--kernel-times {root} failed:\n{out.stderr[-4000:]}")
        runs.append(_child_times(out, root))
    for key in runs[0]:
        if key == "source":
            continue
        print(f"[parent] {key} rows, V 60: parent {runs[0][key]:.3f} / {runs[3][key]:.3f} ms, "
              f"this tree {runs[1][key]:.3f} / {runs[2][key]:.3f} ms | {card}", flush=True)



def engine_times(root: str) -> dict:
    """The 768 LatentRNN's bf16 engine (over the flagship VAE, random
    weights from seed 0) on ``"pallas"``, graph route, through the checkout
    at ``root`` (its package imported, its kernels built into its own
    ``build/``): ms a batch-2,048 call (6/4/6, median of 5) and a batch-1
    call (7/2/7, p50 and p90 of 20). ``presets._latent_rnn`` is handed hidden
    768, so a checkout whose ``build_flagship`` has no ``latent_hidden``
    builds the same model."""
    sys.path[:0] = [root]
    from inpaintnet_tpu_torch.models import presets
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.ops.kernel_common import build_kernels
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    build_kernels()
    real = presets._latent_rnn
    presets._latent_rnn = lambda vae, hidden, *rest: real(vae, WIDE_LATENT_H, *rest)
    model = presets.build_flagship(seed=0, device="cuda")[2]
    if model.gen_hidden_size != WIDE_GEN_H:
        raise RuntimeError(f"the 768 LatentRNN's generation GRU is {model.gen_hidden_size}")
    engine = InpaintingEngine(model, batch_buckets=WIDE_ENGINE_BUCKETS, dtype="bfloat16",
                              device="cuda")
    rng = np.random.default_rng(28)
    big = _request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE)
    one = _request(rng, 1, 7, 2, 7)
    times = {"source": str(Path(presets.__file__).resolve())}
    with gru_impl_scope("pallas"), _route(engine, True):
        times[f"batch {BATCH}"] = cuda_ms(lambda: engine.inpaint(*big, seed=11), 5)
        lat = [cuda_ms(lambda: engine.inpaint(*one, seed=11), 1) for _ in range(20)]
    times["batch 1 p50"] = float(np.median(lat))
    times["batch 1 p90"] = float(np.percentile(lat, 90))
    return times


def phase_parent_engines(parent: str, card: str) -> None:
    """``engine_times`` of ``parent`` and of this tree, each in a process of
    its own, in turns (parent, this, this, parent)."""
    here = str(Path(__file__).resolve().parent)
    runs = []
    for root in (parent, here, here, parent):
        out = subprocess.run([sys.executable, __file__, "--engine-times", root],
                             capture_output=True, text=True, timeout=900, cwd=root)
        if out.returncode != 0:
            raise RuntimeError(f"--engine-times {root} failed:\n{out.stderr[-4000:]}")
        runs.append(_child_times(out, root))
    for key in runs[0]:
        if key != "source":
            print(f"[parent] 768 LatentRNN bfloat16 engine, pallas, graphs, {key}: parent "
                  f"{runs[0][key]:.3f} / {runs[3][key]:.3f} ms, this tree {runs[1][key]:.3f} / "
                  f"{runs[2][key]:.3f} ms | {card}", flush=True)


# The routes at H <= 1,024 that share csrc/gru_fwd_hopper.cuh and
# gru_bwd_hopper.cuh with the tile groups (K1 f32's layers, K5, K6, K8 f32),
# and K8 bf16, whose outputs must not move: (name, H, dtype)
ROUTE_CASES = (("K1 f32", 512, torch.float32), ("K5", 512, torch.float32),
               ("K5", 1024, torch.float32), ("K5", 512, torch.bfloat16),
               ("K5", 1024, torch.bfloat16), ("K6", 1024, torch.float32),
               ("K6", 1024, torch.bfloat16), ("K8", 512, torch.float32),
               ("K8", 1024, torch.float32), ("K8", 1024, torch.bfloat16))
ROUTE_ROWS = (4096, 2048)  # K1's rows x 24 tokens; K5 / K6 / K8's rows x 6 steps


def route_outputs(root: str, out_path: str) -> dict:
    """``ROUTE_CASES`` through the wrappers of the checkout at ``root`` (its
    package imported, its kernels built into its own ``build/``) on inputs
    made from seeds on the card: the outputs saved to ``out_path``
    (``torch.save``), -> {case: median ms}."""
    sys.path[:0] = [root]
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops import gru_kernel as lk
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.ops.kernel_common import build_kernels

    build_kernels()
    outputs, times = {}, {"source": str(Path(lk.__file__).resolve())}
    for i, (name, hidden, dtype) in enumerate(ROUTE_CASES):
        key = f"{name} H {hidden} {str(dtype)[6:]}"
        if name == "K1 f32":
            g = torch.Generator(device="cuda").manual_seed(i)
            gru = [[{k: 0.1 * torch.randn(shape, generator=g, device="cuda")
                     for k, shape in (("w_ih", (10 if layer == 0 else 2 * hidden, 3 * hidden)),
                                      ("w_hh", (hidden, 3 * hidden)), ("b_ih", (3 * hidden,)),
                                      ("b_hh", (3 * hidden,)))}
                    for _ in range(2)] for layer in range(2)]
            table = torch.randn((VOCAB, 10), generator=g, device="cuda")
            tokens = torch.randint(0, VOCAB, (ROUTE_ROWS[0], 24), generator=g, device="cuda",
                                   dtype=torch.int32)
            call = lambda: (ek.encoder_hn(gru, table, tokens),)  # noqa: E731
        elif name in ("K5", "K6"):
            fwd, dys = _train_kernel_case(i, ROUTE_ROWS[1], 6, hidden, dtype, False)
            out = gk.gru_fwd_seq(*fwd)
            hprev = torch.cat([fwd[3][None], out[0][:-1]])
            call = ((lambda: gk.gru_fwd_seq(*fwd)) if name == "K5" else
                    (lambda: gk.gru_bwd_seq(fwd[0], dys, *out[1:], hprev)))
        else:
            args = _gru_layer_inputs(i, ROUTE_ROWS[1], 6, hidden, dtype, "target")
            call = lambda: lk.gru_layer_stream(*args)  # noqa: E731
        outputs[key] = [t.cpu() for t in call() if t is not None]
        times[key] = cuda_ms(call, 10)
    torch.save(outputs, out_path)
    return times


def phase_parent_routes(parent: str, card: str) -> None:
    """``ROUTE_CASES`` through ``parent``'s wrappers and this tree's, each in
    a process of its own, in turns (parent, this, this, parent): the
    outputs bit-equal across all four, the times printed."""
    import tempfile

    here = str(Path(__file__).resolve().parent)
    runs, outs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate((parent, here, here, parent)):
            path = str(Path(tmp) / f"route_outputs_{i}.pt")
            out = subprocess.run([sys.executable, __file__, "--route-outputs", root, path],
                                 capture_output=True, text=True, timeout=900, cwd=root)
            if out.returncode != 0:
                raise RuntimeError(f"--route-outputs {root} failed:\n{out.stderr[-4000:]}")
            runs.append(_child_times(out, root))
            outs.append(torch.load(path))
    for key in outs[0]:
        same = all(len(o[key]) == len(outs[0][key])
                   and all(torch.equal(a, b) for a, b in zip(o[key], outs[0][key]))
                   for o in outs[1:])
        print(f"[parent] {key}: bit-equal to the parent's {same}; parent {runs[0][key]:.3f} / "
              f"{runs[3][key]:.3f} ms, this tree {runs[1][key]:.3f} / {runs[2][key]:.3f} ms | "
              f"{card}", flush=True)
        if not same:
            raise RuntimeError(f"{key}: this tree's outputs differ from the parent's")


# ---------------------------------------------------------------------------
# K8, the generic GRU layer, and the paths that run it: the "pallas" GRU
# route of the LatentRNN engine, and the autoregressive LatentRNN
# ---------------------------------------------------------------------------
# K8 is held to ``gru_kernel.BOUNDS`` (PERF.md gives the readings).
# (label, rows, steps, hidden, mask, outputs): the context GRUs (n_bars
# steps, H 512; the last layer reads h_n only), the generation GRU (6
# target steps, H 512 x 2 layers), the autoregressive generation step, and
# the decoder's beat GRU (4 beats, H 512, unmasked, from h0 = selu(linear(z)))
# over the engine's decode rows (max_target 6 a request), and over one
# measure a request at each autoregressive step
GRU_LAYER_SHAPES = [("context", BATCH, N_BARS, 512, "context", True),
                    ("context h_n", BATCH, N_BARS, 512, "context", False),
                    ("generation", BATCH, 6, 1024, "target", True),
                    ("step", BATCH, 1, 1024, None, True),
                    ("step", 1, 1, 1024, None, True),
                    ("beat", BATCH * 6, 4, 512, None, True),
                    ("beat", BATCH, 4, 512, None, True)]
GRU_YARDSTICK_IN = 256  # cuDNN's input width: z, the context GRUs' and the step's layer-0 input


def k8_launches_per_call(max_target: int, auto_reg: bool) -> int:
    """K8 launches of one engine call under "pallas": the two context GRUs
    (2 layers x 2 directions each), the generation GRU (2 x 2: once, or
    once per target step when autoregressive), and the decoder's beat GRU
    (2 layers, one direction) in each decode call."""
    decodes = max_target if auto_reg else 1
    return 2 * 4 + decodes * 4 + decodes * 2


def gru_layer_ops(rows: int, steps: int, hidden: int) -> float:
    """Multiply-adds x 2 of K8 per call: the (H, 3H) recurrent product per
    row and step (the input projection is computed outside)."""
    return 2.0 * steps * rows * hidden * 3 * hidden


def _gru_layer_inputs(seed: int, rows: int, steps: int, hidden: int, dtype, mask_kind):
    """K8's inputs made on the card from a seed: xw at a layer input's
    projection scale, W_hh at Xavier's, and the engine's masks: "context"
    suffix lengths 0..steps (0: the all-zero row of "no future context"),
    "target" lengths 1..steps, or none."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(dtype)

    args = [randn(rows, steps, 3 * hidden, scale=0.5),
            randn(hidden, 3 * hidden, scale=(2.0 / (4 * hidden)) ** 0.5),
            randn(3 * hidden, scale=0.1), randn(rows, hidden, scale=0.5)]
    mask = None
    if mask_kind is not None:
        low = 0 if mask_kind == "context" else 1
        lengths = torch.randint(low, steps + 1, (rows,), generator=g, device="cuda")
        mask = (torch.arange(steps, device="cuda")[None] < lengths[:, None]).float()
    return (*args, mask)


def cudnn_gru_layer_ms(args, dtype) -> float:
    """K8's recurrence through one PyTorch call, timed as a yardstick only
    (the port never calls it): cuDNN's one-direction ``torch.nn.GRU(256,
    H)`` with the same W_hh and b_hh, over the same rows and steps from the
    same h0, unmasked, on a random x (no PyTorch call takes xw and a hold
    mask; it also computes the input projection, which K8 is given)."""
    xw, w_hh, b_hh, h0, _ = args
    rows, steps, hidden = xw.shape[0], xw.shape[1], w_hh.shape[0]
    net = torch.nn.GRU(GRU_YARDSTICK_IN, hidden, 1, batch_first=True).to(
        device="cuda", dtype=dtype).eval()
    with torch.no_grad():
        net.weight_hh_l0.copy_(w_hh.t())
        net.bias_hh_l0.copy_(b_hh)
        net.flatten_parameters()
        x = torch.randn((rows, steps, GRU_YARDSTICK_IN), device="cuda", dtype=dtype)
        return cuda_ms(lambda: net(x, h0[None]), 3)


def phase_gru_layer_kernel(card: str, parent) -> dict:
    """K8 against its plain version at ``GRU_LAYER_SHAPES``, f32 and bf16
    (every cluster size the bf16 route can take, which must also agree bit
    for bit: the cluster only moves h between CTAs; the f32 route has one
    size a width, H / 64 CTAs, so there a rerun must agree bit for bit),
    forward and reverse; the planted faults; the times of the forward
    direction, bf16 at each cluster size, f32 beside both its bounds and
    the parent's first kernel. -> the report entry of the bf16 context
    shape, with the f32 one beside it."""
    from inpaintnet_tpu_torch.ops import gru_kernel as lk
    from inpaintnet_tpu_torch.ops.kernel_common import cluster_sizes, load_kernels, \
        split_bf16_pieces

    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        bound = lk.BOUNDS[dtype]
        for i, (label, rows, steps, hidden, mask_kind, outputs) in enumerate(GRU_LAYER_SHAPES):
            args = _gru_layer_inputs(20 + i, rows, steps, hidden, dtype, mask_kind)
            shape = f"{dtype} {label} rows {rows} steps {steps} H {hidden} outputs {outputs}"
            clusters = cluster_sizes(hidden) if dtype == torch.bfloat16 else [None]
            plan = lk.card_plan(rows, hidden, args[0].device) if dtype == torch.bfloat16 else None
            chosen = None if plan is None else plan.cluster
            plain = {rev: lk.gru_layer_reference(*args, reverse=rev, want_ys=outputs)
                     for rev in (True, False)}
            got = {}
            for cluster in clusters:
                with _cluster(lk, cluster):
                    for reverse in (True, False):
                        out = lk.gru_layer_stream(*args, reverse=reverse, want_ys=outputs)
                        agree = lk.agreement(out, plain[reverse])
                        print(f"[gru-layer] {shape} cluster {cluster or '-'} reverse {reverse}: "
                              f"{agree} (bound {bound})", flush=True)
                        if not lk.within(agree, bound) or not bool(torch.isfinite(
                                out[1].float()).all()):
                            raise RuntimeError(f"K8 disagrees with its plain version: {shape}")
                        if mask_kind == "context":
                            held = args[4].sum(dim=1) == 0
                            if not (held.any() and torch.equal(out[1][held], args[3][held])):
                                raise RuntimeError(f"K8's all-zero rows do not return h0: {shape}")
                        got[cluster, reverse] = out, agree
            for reverse in (True, False):
                base = got[chosen, reverse][0]
                if dtype == torch.float32:  # one cluster size a width: a rerun
                    again = lk.gru_layer_stream(*args, reverse=reverse, want_ys=outputs)
                    if not all((x is None and y is None) or torch.equal(x, y)
                               for x, y in zip(again, base)):
                        raise RuntimeError(f"K8 f32 differs between two runs: {shape}")
                if not all(all((x is None and y is None) or torch.equal(x, y)
                               for x, y in zip(got[c, reverse][0], base)) for c in clusters):
                    raise RuntimeError(f"K8 differs across cluster sizes: {shape}")
            out, agree = got[chosen, False]
            faults = {}  # name: (planted plain version, reverse)
            if args[4] is not None:
                m = args[4]
                faults["mask read one step late"] = (lk.gru_layer_reference(
                    *args[:4], torch.cat([m[:, :1], m[:, :-1]], dim=1), want_ys=outputs), False)
            if dtype == torch.bfloat16 and steps > 1:
                carry = lk.carry
                lk.carry = lambda h, dtype: h
                try:
                    faults["carry kept in f32"] = (lk.gru_layer_reference(*args, want_ys=outputs),
                                                   False)
                finally:
                    lk.carry = carry
            if dtype == torch.float32:
                product = lk.layer_product
                lk.layer_product = lambda h, w: split_bf16_pieces(h)[0].float() @ w
                try:
                    faults["product on h as one bf16 piece"] = (
                        lk.gru_layer_reference(*args, want_ys=outputs), False)
                finally:
                    lk.layer_product = product
                if args[4] is not None:  # reverse: the rows run after their holds
                    faults["a held row writing no pieces"] = (lk.held_pieces_fault_reference(
                        *args, reverse=True, want_ys=outputs), True)
            for name, (planted, reverse) in faults.items():
                f_agree = lk.agreement(got[chosen, reverse][0], planted)
                print(f"[gru-layer] planted fault {shape}, {name}: {f_agree}", flush=True)
                if lk.within(f_agree, bound):
                    raise RuntimeError(f"a planted K8 fault passes the bounds: {shape}, {name}")
            cluster_ms = {}
            for cluster in clusters:
                with _cluster(lk, cluster):
                    cluster_ms[cluster] = cuda_ms(
                        lambda: lk.gru_layer_stream(*args, want_ys=outputs), 5)
            ms = cluster_ms[chosen]
            plain_ms = cuda_ms(lambda: lk.gru_layer_reference(*args, want_ys=outputs), 2)
            library_ms = cudnn_gru_layer_ms(args, dtype)
            moved = nbytes([a for a in args if a is not None], [o for o in out if o is not None])
            b = bound_of(gru_layer_ops(rows, steps, hidden),
                         "bf16" if dtype == torch.bfloat16 else "f32", moved)
            extra = ""
            if plan is not None:
                per = ", ".join(f"cluster {c} {v:.3f} ms" for c, v in cluster_ms.items())
                extra = f" (cluster {chosen}, stages {plan.stages}; {per})"
            else:  # f32: the split passes' bound, beside the f32 FMA units'
                f32 = lk.f32_plan(hidden)
                b = {**bound_of(6 * gru_layer_ops(rows, steps, hidden), "bf16", moved),
                     "bound_f32_fma_ms": b["bound_ms"]}
                slots = load_kernels().inpaint_gru_layer_f32_slots(hidden, f32.cluster,
                                                                   f32.stages)
                alone = _device_ms(lambda: lk.gru_layer_stream(*args, want_ys=outputs),
                                   "gru_fwd_kernel")
                extra = (f" (cluster {f32.cluster}, stages {f32.stages}, {slots} clusters at "
                         f"once; the kernel alone {alone:.3f} ms device), the parent's f32 "
                         f"kernel {parent_ms(parent, lambda pk: pk.gru_layer_f32(*args, outputs))}"
                         f", f32 FMA bound {b['bound_f32_fma_ms']:.4f} ms")
            print(f"[time] gru_layer_stream {shape}: kernel {ms:.3f} ms{extra}, plain "
                  f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); cuDNN "
                  f"torch.nn.GRU({GRU_YARDSTICK_IN}, {hidden}) one direction, unmasked, "
                  f"yardstick {library_ms:.3f} ms | {card}", flush=True)
            if label == "context":
                entry = {"max_abs_err": agree["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                         **b, "library_ms": library_ms}
                if dtype == torch.float32:
                    f32_entry = entry
                else:
                    report["gru_layer_stream"] = {**entry, "f32": f32_entry}
    return report


def _eager_gru_steps(fn, width=None):
    """-> (fn(), how many eager GRU steps ``ops/gru.py``'s loop ran; with
    ``width``, only those of that hidden size)."""
    from inpaintnet_tpu_torch.ops import gru as gru_mod

    real, count = gru_mod.gru_gates, [0]

    def counted(params, h, xw):
        count[0] += width is None or h.shape[-1] == width
        return real(params, h, xw)

    gru_mod.gru_gates = counted
    try:
        return fn(), count[0]
    finally:
        gru_mod.gru_gates = real


def _route_calls(engine, requests, impl: str, auto_reg: bool):
    """Each request once under the GRU route ``impl``, checked, with its K8
    launches and eager GRU steps asserted, on the engine's eager route (a
    graph replay runs no Python GRU step to count). -> {label: response}"""
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.ops.gru_kernel import gru_layer_stream

    outs = {}
    with gru_impl_scope(impl), _route(engine, False):
        for label, tokens, start, num in requests:
            before = gru_layer_stream.launches
            out, steps = _eager_gru_steps(lambda: engine.inpaint(tokens, start, num, seed=5))
            k8 = gru_layer_stream.launches - before
            _check_response(out, tokens, start, num)
            want = k8_launches_per_call(engine.max_target, auto_reg) if impl == "pallas" else 0
            print(f"[gru-route] {impl} {label}: K8 launches {k8} (expected {want}), eager GRU "
                  f"steps {steps}", flush=True)
            if k8 != want or (steps == 0) != (impl == "pallas"):
                raise RuntimeError(f"the {impl} route of {label} took the wrong GRU path")
            outs[label] = out
    return outs


def phase_gru_routes(engine, card: str) -> None:
    """The bf16 LatentRNN engine (non-autoregressive) under ``"pallas"``
    beside ``"xla"``, one run: K8 launches per call and eager GRU steps
    asserted; the batch-2048 (6/4/6) wall and the batch-1 p50 timed in turns
    (xla, pallas, pallas, xla); a profile of each."""
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope

    rng = np.random.default_rng(13)
    requests = [(f"batch {BATCH} 6/4/6", *_request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE)),
                ("batch 1 7/2/7", *_request(rng, 1, 7, 2, 7))]
    outs = {impl: _route_calls(engine, requests, impl, False) for impl in ("xla", "pallas")}
    big, one = requests[0][1:], requests[1][1:]
    same = (outs["xla"][requests[0][0]] == outs["pallas"][requests[0][0]]).mean()
    print(f"[gru-route] pallas and xla agree on {same:.4f} of the batch-{BATCH} tokens (bf16 "
          "rounds otherwise on the two routes; random weights: printed, no limit)", flush=True)
    walls = {"xla": ([], []), "pallas": ([], [])}
    for impl in ("xla", "pallas", "pallas", "xla"):
        with gru_impl_scope(impl):
            walls[impl][0].append(cuda_ms(lambda: engine.inpaint(*big, seed=5), 3))
            walls[impl][1].extend(cuda_ms(lambda: engine.inpaint(*one, seed=5), 1)
                                  for _ in range(10))
    route = _route_name(engine)
    for impl, (w_big, w_one) in walls.items():
        t_big, p50 = float(np.median(w_big)), float(np.median(w_one))
        print(f"[time] engine bf16 GRU route {impl} ({route}): batch {BATCH} 6/4/6 {t_big:.2f} "
              f"ms per call, {BATCH * N_TARGET / (t_big / 1e3):.1f} measures/s; batch 1 p50 "
              f"{p50:.2f} ms (p90 {np.percentile(w_one, 90):.2f} ms) | {card}", flush=True)
        with gru_impl_scope(impl):
            _profile_line(f"engine bf16 {impl} ({route}) batch {BATCH}",
                          lambda: engine.inpaint(*big, seed=5), t_big, card, top=6)
            _profile_line(f"engine bf16 {impl} ({route}) batch 1",
                          lambda: engine.inpaint(*one, seed=5), p50, card, top=6)


def phase_autoreg_reference(card: str) -> None:
    """The autoregressive LatentRNN on the card (K1, K2, K8) against the
    same model on the CPU (plain versions), f32, H 64 (generation hidden
    128), the same injected context and re-encode noise, under
    ``"pallas"``: z and tokens, and K8's launches."""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.ops.gru_kernel import gru_layer_stream

    _, _, model = build_flagship(hidden=64, z_dim=16, seed=3, device="cpu", auto_reg=True)
    rng = np.random.default_rng(14)
    b, mt = 4, model.max_target
    past = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    future = rng.integers(0, VOCAB, (b, N_BARS, 24)).astype(np.int32)
    pm = (np.arange(N_BARS) < np.array([[1], [6], [16], [3]])).astype(np.float32)
    fm = (np.arange(N_BARS) < np.array([[0], [6], [16], [9]])).astype(np.float32)
    tm = (np.arange(mt) < N_TARGET)[None].repeat(b, 0).astype(np.float32)
    eps = rng.standard_normal((b * 2 * N_BARS, model.z_dim)).astype(np.float32)
    eps_steps = rng.standard_normal((mt - 1, b, model.z_dim)).astype(np.float32)

    def run(dev):
        params = cast_params(model.params(), dev, torch.float32)
        vae_params = cast_params(model.vae_model.params(), dev, torch.float32)
        a = [torch.from_numpy(x).to(dev) for x in (past, future, pm, fm, tm, eps, eps_steps)]
        with torch.inference_mode(), gru_impl_scope("pallas"):
            lg, s, z = model.apply(params, vae_params, a[0], a[1], None, past_mask=a[2],
                                   future_mask=a[3], target_mask=a[4], eps=a[5], eps_steps=a[6])
        return lg.cpu(), s.cpu(), z.cpu()

    before = gru_layer_stream.launches
    (lg, s, z), (_, s_cpu, z_cpu) = run("cuda"), run("cpu")
    k8 = gru_layer_stream.launches - before
    err, agree = (z - z_cpu).abs().max().item(), (s == s_cpu).float().mean().item()
    print(f"[autoreg-reference] f32 H 64, card vs CPU plain: gen z max_abs_err {err:.3e} (bound "
          f"1e-5), tokens equal {agree:.4f} (bound 1), finite {bool(torch.isfinite(lg).all())}; "
          f"K8 launches {k8} | {card}", flush=True)
    if not (err <= 1e-5 and agree == 1.0 and bool(torch.isfinite(lg).all())):
        raise RuntimeError("the autoregressive path on the card disagrees with the CPU")
    if k8 != k8_launches_per_call(mt, True):
        raise RuntimeError(f"the autoregressive path launched K8 {k8} times")


def phase_autoreg_engine(card: str):
    """The autoregressive flagship engine, bf16, under ``"pallas"``: three
    requests checked, K1/K2/K8 launches per call asserted (1 context encode
    + max_target - 1 re-encodes, max_target decodes, and
    ``k8_launches_per_call``), tiled variations, then the times and a profile
    of each batch. -> (engine, {kernel: launches})"""
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops.encoder_kernel import encoder_hn
    from inpaintnet_tpu_torch.ops.decode_kernel import decode_sampling
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.ops.gru_kernel import gru_layer_stream
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    _, _, model = build_flagship(seed=0, device="cuda", auto_reg=True)
    engine = InpaintingEngine(model, batch_buckets=BUCKETS, dtype="bfloat16", device="cuda")
    mt = engine.max_target
    kernels = (encoder_hn, decode_sampling, gru_layer_stream)
    want = {"encoder_hn": mt, "decode_sampling": mt,
            "gru_layer_stream": k8_launches_per_call(mt, True)}
    rng = np.random.default_rng(15)
    requests = [("batch 1, 2-measure span", *_request(rng, 1, 7, 2, 7)),
                ("batch 8, 6/4/6", *_request(rng, 8, N_PAST, N_TARGET, N_FUTURE)),
                (f"batch {BATCH}, 6/4/6", *_request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE))]
    with gru_impl_scope("pallas"):
        engine.warmup()

        def serve():
            for label, tokens, start, num in requests:
                before = [k.launches for k in kernels]
                out = engine.inpaint(tokens, start, num, seed=11)
                got = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
                _check_response(out, tokens, start, num)
                if not np.array_equal(out, engine.inpaint(tokens, start, num, seed=11)):
                    raise RuntimeError(f"autoregressive {label}: the same seed gave other tokens")
                if got != want:
                    raise RuntimeError(f"autoregressive {label}: launches {got}, expected {want}")
                print(f"[autoreg-engine] bf16 {label}: ok, launches a call {got}, "
                      f"{(out[:, start:start + num] != tokens[:, start:start + num]).mean():.3f} "
                      f"of span tokens differ from the input", flush=True)
            tokens, start, num = requests[1][1:]
            var = engine.inpaint_variations(tokens, start, num, num_variations=3, seed=2)
            for v in var:
                _check_response(v, tokens, start, num)
            if len({v[:, start:start + num].tobytes() for v in var}) != 3:
                raise RuntimeError("autoregressive variations are not distinct draws")

        _, launches = _launches_during(kernels, serve)
        print(f"[autoreg-engine] launches during the requests: {launches}", flush=True)
        big, one = requests[2][1:], requests[0][1:]
        t_big = cuda_ms(lambda: engine.inpaint(*big, seed=5), 3)
        lat = [cuda_ms(lambda: engine.inpaint(*one, seed=5), 1) for _ in range(20)]
        route = _route_name(engine)
        print(f"[time] autoreg engine bf16 pallas ({route}) batch {BATCH} 6/4/6: {t_big:.2f} ms "
              f"per call, {BATCH * N_TARGET / (t_big / 1e3):.1f} measures/s | {card}", flush=True)
        print(f"[time] autoreg engine bf16 pallas ({route}) batch 1 2-measure: p50 "
              f"{np.median(lat):.2f} ms (p90 {np.percentile(lat, 90):.2f} ms) | {card}",
              flush=True)
        _profile_line(f"autoreg bf16 ({route}) batch {BATCH}",
                      lambda: engine.inpaint(*big, seed=5), t_big, card)
        _profile_line(f"autoreg bf16 ({route}) batch 1", lambda: engine.inpaint(*one, seed=5),
                      float(np.median(lat)), card)
        _plan_device_ms(engine, {f"batch {BATCH}": big, "batch 1": one}, card)
    return engine, launches


def _neighbour_plan(plan_fn, factor):
    """``plan_fn`` with its cluster size times ``factor`` where the width
    allows that size, else its own."""
    from inpaintnet_tpu_torch.ops.kernel_common import cluster_sizes

    def plan(rows, hidden, sms, slots=None):
        chosen = plan_fn(rows, hidden, sms, slots)
        c = int(chosen.cluster * factor)
        return chosen._replace(cluster=c) if c in cluster_sizes(hidden) else chosen
    return plan


def _plan_device_ms(engine, requests: dict, card: str) -> None:
    """K8's and K2's device time in one call of each request
    (``torch.profiler``) with their launch plans, and with each shape's
    neighbours: half and twice the plan's cluster size where the width
    allows, in turns (plan, half, twice, twice, half, plan), on the eager
    route (a replay keeps the plans of its capture). The plans held on the
    call's own launch mix, within one run."""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops import gru_kernel as lk

    arms = {"launch_plan": 1, "half": 0.5, "twice": 2}
    real = {m: m.launch_plan for m in (lk, dk)}
    for label, req in requests.items():
        k8 = {a: [] for a in arms}
        k2 = {a: [] for a in arms}
        for arm in ("launch_plan", "half", "twice", "twice", "half", "launch_plan"):
            for m in (lk, dk):
                m.launch_plan = _neighbour_plan(real[m], arms[arm])
            try:
                with _route(engine, False):
                    rows = _profile_step(lambda: engine.inpaint(*req, seed=5))[2]
            finally:
                for m in (lk, dk):
                    m.launch_plan = real[m]
            k8[arm].append(sum(ms for name, ms, _ in rows if "gru_layer_kernel" in name))
            k2[arm].append(sum(ms for name, ms, _ in rows if "decode_kernel<" in name))
        for kernel, got in (("K8", k8), ("K2", k2)):
            print(f"[plan] autoreg bf16 {label}: {kernel} device ms a call, " + "; ".join(
                f"{arm} {[round(v, 3) for v in vals]}" for arm, vals in got.items())
                + f" | {card}", flush=True)


def phase_autoreg_http(engine, card: str) -> dict:
    """The port's HTTP server over the autoregressive engine, under
    ``"pallas"``, dynamic batching pinned to bucket 64: 16 concurrent
    ``/v1/inpaint`` responses must equal the solo ``inpaint_hetero``, and
    variation 0 of ``/v1/inpaint_variations`` the seeded ``/v1/inpaint``."""
    from inpaintnet_tpu_torch.ops.encoder_kernel import encoder_hn
    from inpaintnet_tpu_torch.ops.decode_kernel import decode_sampling
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.ops.gru_kernel import gru_layer_stream
    from inpaintnet_tpu_torch.server import InpaintingServer

    pin = 64
    rng = np.random.default_rng(16)
    reqs = []
    for i in range(16):
        m = int(rng.integers(4, N_BARS + 1))
        num = int(rng.integers(1, min(engine.max_target, m - 1) + 1))
        reqs.append({"tokens": rng.integers(0, VOCAB, (int(rng.integers(1, 4)), m, 24)),
                     "start_measure": int(rng.integers(1, m - num + 1)), "num_measures": num,
                     "seed": 3000 + i})
    with gru_impl_scope("pallas"):
        engine.warmup(buckets=(pin,), hetero=True)
        server = InpaintingServer(engine, port=0, batching=True, pin_bucket=pin)
        port = server.start()
        try:
            (results, wall), launches = _launches_during(
                (encoder_hn, decode_sampling, gru_layer_stream),
                lambda: _burst(port, "/v1/inpaint", reqs, "tokens"))
            calls = _http(port, "GET", "/healthz")["batching"]["calls"]
            for req, got in zip(reqs, results):
                if not np.array_equal(got, engine.inpaint_hetero([req], bucket=pin)[0]):
                    raise RuntimeError(f"an autoregressive /v1/inpaint response differs from the "
                                       f"solo inpaint_hetero (seed {req['seed']})")
            one = {**reqs[0], "seed": 77}
            var = np.asarray(_http(port, "POST", "/v1/inpaint_variations",
                                   {**one, "num_variations": 3})["variations"])
            if not np.array_equal(var[0], np.asarray(_http(port, "POST", "/v1/inpaint",
                                                           one)["tokens"])):
                raise RuntimeError("autoregressive variation 0 differs from the seeded /v1/inpaint")
        finally:
            server.stop()
    print(f"[autoreg-http] {len(reqs)} concurrent /v1/inpaint: every response equals the solo "
          f"inpaint_hetero at bucket {pin}; {calls} coalesced device calls; {wall * 1e3:.1f} ms "
          f"wall; variation 0 == /v1/inpaint; launches {launches} | {card}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# AnticipationRNN training (phase 19)
# ---------------------------------------------------------------------------
def _folk_nbars(root: Path, tunes: int, num_bars: int = N_BARS):
    """The port's ``FolkDatasetNBars`` (beat marker and tick channels) over a
    fresh synthetic corpus of ``tunes`` tunes (seed 7), built under
    ``root``. -> (dataset with its arrays built, host seconds)."""
    from inpaintnet_tpu_torch.data import BeatMarkerMetadata, DatasetManager, TickMetadata
    from inpaintnet_tpu_torch.data.synthetic import generate_corpus

    t0 = time.perf_counter()
    generate_corpus(str(root / "corpus"), num_tunes=tunes, num_bars=16, seed=7)
    ds = DatasetManager(cache_dir=str(root / "cache"), corpus_dir=str(root / "corpus")) \
        .get_dataset("folk_4by4nbars_train", metadatas=[BeatMarkerMetadata(6), TickMetadata(6)],
                     num_bars=num_bars, train=True)
    ds.arrays
    return ds, time.perf_counter() - t0


def phase_arnn_data(root: Path, card: str):
    """The 200-tune dataset the full-width trainers read."""
    from inpaintnet_tpu_torch.data.native import NativeTokenizer

    ds, seconds = _folk_nbars(root, ARNN_TUNES)
    score, md = ds.arrays
    print(f"[arnn-data] FolkDatasetNBars over {ARNN_TUNES} synthetic tunes: {score.shape[0]} "
          f"windows of {score.shape[-1]} ticks, metadata {tuple(md.shape[1:])}, vocabulary "
          f"{len(ds.vocab)}, {seconds:.2f} s on the host; native tokenizer "
          f"{'used' if NativeTokenizer.available() else 'not built (Python tokenizer)'} "
          f"| {card}", flush=True)
    if len(ds.vocab) > 64:
        raise RuntimeError(f"vocabulary {len(ds.vocab)}: K7's Hopper routes take at most 64")
    return ds


class _Bars:
    """A dataset's vocabulary, metadata channels and measure geometry over
    its windows cut to ``n_bars``: what the ARNN models and trainers read."""

    def __init__(self, ds, n_bars: int):
        self.n_bars = n_bars
        for name in ("note2index_dicts", "metadatas", "num_voices", "subdivision",
                     "num_beats_per_bar"):
            setattr(self, name, getattr(ds, name))
        self.ticks = n_bars * ds.subdivision * ds.num_beats_per_bar

    def __repr__(self):
        return f"Bars({self.n_bars})"


def _arnn_model(kind: str, ds, hidden: int, device, seed: int):
    """``train_arnn_baseline.py``'s / ``train_arnn_reg.py``'s model: note
    embedding 10, metadata embedding 2, 2-layer LSTMs and linear of
    ``hidden``, dropout 0.2 between the layers and on the input, unary
    constraints, teacher forcing."""
    from inpaintnet_tpu_torch.models.anticipation_rnn import (
        AnticipationRNNBaseline,
        ConstraintModelGaussianReg,
    )

    cls = ConstraintModelGaussianReg if kind == "reg" else AnticipationRNNBaseline
    return cls(ds, note_embedding_dim=10, metadata_embedding_dim=2,
               num_lstm_constraints_units=hidden, num_lstm_generation_units=hidden,
               linear_hidden_size=hidden, num_layers=2, dropout_input_prob=0.2,
               dropout_prob=0.2, unary_constraint=True, teacher_forcing=True, device=device,
               seed=seed)


def _arnn_trainer_class(kind: str):
    from inpaintnet_tpu_torch.train import (
        AnticipationRNNBaselineTrainer,
        AnticipationRNNGaussianRegTrainer,
    )

    return AnticipationRNNGaussianRegTrainer if kind == "reg" else AnticipationRNNBaselineTrainer


def _check_no_tf32() -> None:
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("TF32 products are on: the f32 path must compute f32 products in f32")


def phase_arnn_train_reference(ds, card: str) -> None:
    """ARNN train steps on the card against the same steps on the CPU, f32,
    H 64, 4 windows of the dataset cut to 9 bars: each trainer takes two
    Adam steps (lr 1e-3), teacher-forced then sampled, from the same
    parameters (seed 5), constraint masks (the same host stream) and
    dropout masks (a seeded CPU generator on both devices). The sampled
    branch's tokens must equal the CPU's; loss, gradients and parameters
    stay within ``TRAIN_REF``, phase 9's bounds for phase 9's reasons; K7
    never launches."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.ops.arnn_kernel import arnn_sampled_decode

    bars = _Bars(ds, 9)
    windows = tuple(a[:4, :, :bars.ticks] for a in ds.arrays)
    for kind in ("reg", "baseline"):
        model = _arnn_model(kind, bars, 64, "cpu", seed=5)
        tokens, scan = [], model._sampled_scan

        def recorded(*a, **k):
            out = scan(*a, **k)
            tokens.append(out[1].detach().cpu())
            return out

        model._sampled_scan = recorded
        trainers = {}
        for dev in ("cuda", "cpu"):
            trainers[dev] = _arnn_trainer_class(kind)(bars, model, lr=1e-3, device=dev, seed=1)
            trainers[dev].generator = torch.Generator().manual_seed(11)
        for step, coin in enumerate((True, False)):
            label = f"{kind} {'teacher-forced' if coin else 'sampled'}"
            out = {}
            for dev, tr in trainers.items():
                tokens.clear()
                before = arnn_sampled_decode.launches
                loss, _ = tr.train_step(tr.process_batch_data(windows), coin=coin)
                leaves = [p for _, p in iter_leaves(tr.params)]
                out[dev] = (loss.item(),
                            [torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
                             for p in leaves],
                            [p.detach().cpu() for p in leaves],
                            torch.cat(tokens) if tokens else None,
                            arnn_sampled_decode.launches - before)
            (l_c, g_c, p_c, t_c, k7), (l_p, g_p, p_p, t_p, _) = out["cuda"], out["cpu"]
            loss_err = abs(l_c - l_p) / abs(l_p)
            g_err = max(((a - c).abs() / (1.0 + c.abs())).max().item()
                        for a, c in zip(g_c, g_p))
            p_diff = torch.cat([(a - c).abs().flatten() for a, c in zip(p_c, p_p)])
            agree = None if t_c is None else (t_c == t_p).float().mean().item()
            print(f"[arnn-train-ref] {label} step {step}: loss card {l_c:.7f} cpu {l_p:.7f} "
                  f"rel err {loss_err:.3e} (bound {TRAIN_REF['loss']:.0e}); gradients max "
                  f"|d|/(1+|g|) {g_err:.3e} (bound {TRAIN_REF['grad']:.0e}); post-Adam "
                  f"params max {p_diff.max().item():.3e} (bound "
                  f"{TRAIN_REF['param_max']:.0e}), mean {p_diff.mean().item():.3e} (bound "
                  f"{TRAIN_REF['param_mean']:.0e}); sampled tokens equal "
                  f"{'-' if agree is None else f'{agree:.6f}'}; K7 launches {k7} | {card}",
                  flush=True)
            if k7 != 0:
                raise RuntimeError(f"{label}: a train step launched K7 {k7} times")
            if (t_c is None) != coin or (agree is not None and agree < 1.0):
                raise RuntimeError(f"{label} step {step}: the sampled branch's tokens "
                                   f"differ from the CPU's (equal share {agree})")
            if not (loss_err <= TRAIN_REF["loss"] and g_err <= TRAIN_REF["grad"]
                    and p_diff.max().item() <= TRAIN_REF["param_max"]
                    and p_diff.mean().item() <= TRAIN_REF["param_mean"]):
                raise RuntimeError(f"the ARNN train step on the card disagrees with the "
                                   f"CPU ({label}, step {step})")


ARNN_LABELS = ("arnn.step", "arnn.forward", "arnn.constraint", "arnn.adam")
_UNSET = object()


@contextlib.contextmanager
def _labelled_parts(tr):
    """Name the parts of ``tr``'s step for the profiler: the loss
    (``arnn.forward``), the constraint stack inside it (``arnn.constraint``)
    and Adam (``arnn.adam``). The instance attributes are put back on exit."""
    targets = ((tr, "loss_and_metrics", "arnn.forward"),
               (tr.model, "output_lstm_constraints", "arnn.constraint"),
               (tr.optimizer, "step", "arnn.adam"))

    def labelled(fn, label):
        def run(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return run

    saved = [(obj, name, obj.__dict__.get(name, _UNSET)) for obj, name, _ in targets]
    for obj, name, label in targets:
        setattr(obj, name, labelled(getattr(obj, name), label))
    try:
        yield
    finally:
        for obj, name, old in saved:
            if old is _UNSET:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def _launch_split(spans: dict, launches: list) -> dict:
    """Host launches (the ``cuda*LaunchKernel*`` runtime calls' start times)
    of one traced step by part: each goes to the innermost labelled part
    whose span holds it; the generation stack or loop is the forward less
    the constraint stack (with the head and the loss, 24-35 launches), the
    backward the rest of the step. Host-side, so a kernel the trace lost
    on the device does not move a launch between parts. Empty when the
    trace holds no runtime calls."""
    def inside(t, label):
        return any(a <= t <= b for a, b in spans.get(label, ()))

    split = {"constraint": 0, "generation": 0, "backward": 0, "adam": 0}
    for t in launches:
        if not inside(t, "arnn.step"):
            continue
        part = next((key for label, key in (("arnn.adam", "adam"),
                                            ("arnn.constraint", "constraint"),
                                            ("arnn.forward", "generation"))
                     if inside(t, label)), "backward")
        split[part] += 1
    return split if sum(split.values()) else {}


def _arnn_profile(tr, batch, coin) -> tuple:
    """One labelled train step traced on the card, read from kineto's raw
    events (not parsed into a tree of ``FunctionEvent``s, which takes ~50 s
    of the host for ~90,000 kernels and their ops). A trace that recorded
    no device activity is taken again, up to twice. -> (device ms, device
    launches, [(kernel, ms, launches)] by time, longest first, the host
    launches by part (``_launch_split``))."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with _labelled_parts(tr), torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
            torch.cuda.synchronize()
            with torch.profiler.record_function("arnn.step"):
                loss, _ = tr.train_step(batch, coin=coin)
                loss.item()
            torch.cuda.synchronize()
        device, host, spans, launches = [], set(), {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((name, e.duration_ns()))
                continue
            host.add(name)
            if name in ARNN_LABELS:
                spans.setdefault(name, []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif "LaunchKernel" in name:
                launches.append(e.start_ns())
        by_name = {}
        for name, ns in device:
            # a device range named as a host event is a record_function
            # label's (ours, or Adam's own), not a kernel
            if "spin_kernel" not in name and name not in host:
                ms, n = by_name.get(name, (0.0, 0))
                by_name[name] = (ms + ns / 1e6, n + 1)
        if by_name:
            break
        print(f"[profile] no device activity recorded (attempt {attempt + 1}); tracing again",
              flush=True)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), rows,
            _launch_split(spans, launches))


def _validate_on_k7(tr, batch, label: str, dtype):
    """One validation batch of ``tr``: K7 launches once, and its call
    (recorded where the model calls it) holds against its plain version on
    the same inputs within ``ARNN_BOUNDS``. -> the validation loss."""
    from inpaintnet_tpu_torch.models import anticipation_rnn as tarnn
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    real, calls = tarnn.arnn_sampled_decode, []

    def recorded(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    before = ak.arnn_sampled_decode.launches
    tarnn.arnn_sampled_decode = recorded
    try:
        loss = tr.eval_step(batch)[0].item()
    finally:
        tarnn.arnn_sampled_decode = real
    k7 = ak.arnn_sampled_decode.launches - before
    if k7 != 1 or len(calls) != 1 or not np.isfinite(loss):
        raise RuntimeError(f"{label} validation batch: K7 launched {k7} times (expected 1); "
                           f"loss {loss}")
    args, got = calls[0]
    agree = ak.decode_agreement(got, ak.arnn_sampled_decode_reference(*args), args[3])
    b = ARNN_BOUNDS[dtype]
    print(f"[arnn-trainer] {label} validation batch, K7 at {tuple(args[2].shape)} against its "
          f"plain version: {_agreement_line(agree)} (bounds {b})", flush=True)
    if not ak.within(agree, b) or not bool(torch.isfinite(got[0].float()).all()):
        raise RuntimeError(f"{label}: K7 in the validation batch disagrees with its plain "
                           f"version")
    return loss


def phase_arnn_trainer(ds, card: str) -> dict:
    """Both ARNN trainers at the width of ``train_arnn_baseline.py`` /
    ``train_arnn_reg.py`` (random weights from seed 0) on the dataset's
    first 32 windows, in f32 and in bf16 compute, 4 steps each (coins
    alternating, teacher-forced first; steps 0-1 warm up, 2-3 are timed, ms
    a step being the mean of the branches' times), and the reg trainer's
    K7 device time in a validation batch; then one profiled step of each
    branch of the reg trainer in f32 (``_arnn_profile``). Every train step
    launches K7 0 times and each validation batch (the next 32 windows)
    once, and that call holds against K7's plain version
    (``_validate_on_k7``); the loss is finite and the parameters move.
    -> {kernel: launches} over the phase."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    _check_no_tf32()
    score, md = ds.arrays
    train_batch = (score[:ARNN_WINDOWS], md[:ARNN_WINDOWS])
    val_batch = (score[ARNN_WINDOWS:2 * ARNN_WINDOWS], md[ARNN_WINDOWS:2 * ARNN_WINDOWS])
    vocab = len(ds.note2index_dicts[0])

    t_phase = time.perf_counter()

    def drive():
        for kind in ("reg", "baseline"):
            for compute in (None, "bfloat16"):
                label = f"{kind} {compute or 'float32'}"
                dtype = torch.bfloat16 if compute else torch.float32
                model = _arnn_model(kind, ds, 256, "cuda", seed=0)
                tr = _arnn_trainer_class(kind)(ds, model, lr=1e-4, device="cuda",
                                              compute_dtype=compute, seed=1)
                start = [p.detach().clone() for _, p in iter_leaves(tr.params)]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times, targets = {}, []
                for i, coin in enumerate((True, False) * 2):
                    batch = tr.process_batch_data(train_batch)
                    before = ak.arnn_sampled_decode.launches
                    t0 = time.perf_counter()
                    loss, _ = tr.train_step(batch, coin=coin)
                    loss = loss.item()  # waits for the step
                    wall = (time.perf_counter() - t0) * 1e3
                    if i >= 2:
                        times.setdefault(coin, []).append(wall)
                        targets.append(int((1 - batch[2]).sum().item()))
                    k7 = ak.arnn_sampled_decode.launches - before
                    if k7 != 0 or not np.isfinite(loss):
                        raise RuntimeError(f"{label} step {i} (coin {coin}): K7 launched {k7} "
                                           f"times (expected 0); loss {loss}")
                peak = torch.cuda.max_memory_allocated()
                moved = sum((p.detach() - s).abs().sum().item()
                            for (_, p), s in zip(iter_leaves(tr.params), start))
                if not moved > 0:
                    raise RuntimeError(f"{label}: the parameters did not move")
                val_loss = _validate_on_k7(tr, tr.process_batch_data(val_batch), label, dtype)
                k7_line = ""
                if kind == "reg":
                    vb = tr.process_batch_data(val_batch)
                    parts, n = k7_parts(lambda: tr.eval_step(vb), ak.arnn_cuda_launches(
                        dtype, ARNN_WINDOWS, score.shape[-1], 256, 256, vocab), dtype)
                    k7_line = (f"; K7 in a validation batch: device {sum(parts.values()):.3f} ms "
                               f"({', '.join(f'{k} {v:.3f}' for k, v in parts.items())}; {n} "
                               f"CUDA launches)")
                walls = {c: float(np.median(t)) for c, t in times.items()}
                ms = float(np.mean(list(walls.values())))
                per_step = float(np.mean(targets))
                print(f"[arnn-trainer] {label} ({time.perf_counter() - t_phase:.1f} s into "
                      f"the phase): {ms:.2f} ms/step (teacher-forced "
                      f"{walls[True]:.2f}, sampled {walls[False]:.2f}), "
                      f"{ARNN_WINDOWS / (ms / 1e3):.1f} windows/s, "
                      f"{per_step / (ms / 1e3):.1f} target ticks/s ({per_step:.1f} a step), "
                      f"peak memory {peak / 2**30:.3f} GiB, last loss {loss:.5f}, validation "
                      f"loss {val_loss:.5f}; K7 launches: 0 a train step, 1 a "
                      f"validation batch{k7_line} | {card}", flush=True)
                if kind == "reg" and compute is None:
                    for coin in (True, False):
                        t0 = time.perf_counter()
                        device_ms, count, rows, split = _arnn_profile(
                            tr, tr.process_batch_data(train_batch), coin)
                        branch = "teacher-forced" if coin else "sampled"
                        print(f"[profile] arnn {label} {branch}: device {device_ms:.2f} "
                              f"ms/step, {count} launches/step, idle share "
                              f"{1 - device_ms / walls[coin]:.3f} (of the unprofiled median "
                              f"wall {walls[coin]:.2f} ms); host launches by part "
                              f"{split or 'not measured (no runtime calls traced)'}; traced "
                              f"and read in {time.perf_counter() - t0:.1f} s | {card}",
                              flush=True)
                        for name, k_ms, k_count in rows[:10]:
                            print(f"[profile]   {k_ms:9.3f} ms {k_count:6d}x  {name[:110]}",
                                  flush=True)
                del tr, model, start
                torch.cuda.empty_cache()

    ak.arnn_sampled_decode.launches = 0
    drive()
    launches = {"arnn_sampled_decode": ak.arnn_sampled_decode.launches}
    print(f"[arnn-trainer] launches in the full-width runs: {launches}", flush=True)
    if launches["arnn_sampled_decode"] < 1:
        raise RuntimeError(f"the ARNN training path launched {launches}")
    return launches


def phase_arnn_train_model(root: Path, card: str) -> int:
    """``train_model`` for one epoch at full width (f32, the baseline
    trainer) on a 4-tune corpus, batch 32; then a fresh trainer's
    ``load_state`` restores the parameters, the Adam state and the epoch
    exactly on the card. -> K7 launches in the epoch."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    ds, seconds = _folk_nbars(root / "small", ARNN_SMALL_TUNES)
    ckpt = str(root / "checkpoints")

    def fresh(seed):
        model = _arnn_model("baseline", ds, 256, "cuda", seed=seed)
        model.checkpoint_dir = ckpt
        return _arnn_trainer_class("baseline")(ds, model, lr=1e-4, device="cuda", seed=1)

    trainer = fresh(0)
    _, val, _ = ds.data_loaders(batch_size=ARNN_WINDOWS, split=(0.70, 0.20), seed=1)
    before = ak.arnn_sampled_decode.launches
    t0 = time.perf_counter()
    trainer.train_model(batch_size=ARNN_WINDOWS, num_epochs=1, split=(0.70, 0.20))
    epoch_s = time.perf_counter() - t0
    k7 = ak.arnn_sampled_decode.launches - before
    if k7 != len(val) or trainer.epoch != 1:
        raise RuntimeError(f"train_model: K7 launched {k7} times over {len(val)} validation "
                           f"batches; epoch {trainer.epoch}")
    resumed = fresh(2)
    if resumed.load_state() != 1 or resumed.epoch != 1:
        raise RuntimeError("load_state did not restore the epoch")
    for (k, p), (_, q) in zip(iter_leaves(resumed.params), iter_leaves(trainer.params)):
        s, t = resumed.optimizer.state[p], trainer.optimizer.state[q]
        if not (p.is_cuda and torch.equal(p, q) and set(s) == set(t)
                == {"step", "exp_avg", "exp_avg_sq"}
                and all(torch.equal(s[n], t[n]) for n in s)):
            raise RuntimeError(f"load_state did not restore {k} exactly")
    print(f"[arnn-train-model] one epoch on {ARNN_SMALL_TUNES} tunes "
          f"({ds.arrays[0].shape[0]} windows, dataset {seconds:.2f} s on the host): "
          f"{epoch_s:.2f} s, K7 launches {k7} (one a validation batch); load_state restored "
          f"the parameters, Adam state and epoch exactly | {card}", flush=True)
    return k7


def phase_arnn_training(card: str) -> dict:
    """Phase 19, in a temporary directory. -> {kernel: launches}."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ds = phase_arnn_data(root, card)
        phase_arnn_train_reference(ds, card)
        t1 = time.perf_counter()
        launches = phase_arnn_trainer(ds, card)
        t2 = time.perf_counter()
        launches["arnn_sampled_decode"] += phase_arnn_train_model(root, card)
    print(f"[arnn] phase 19: {time.perf_counter() - t0:.1f} s (data and the card against the "
          f"CPU {t1 - t0:.1f} s, full width {t2 - t1:.1f} s, train_model "
          f"{time.perf_counter() - t2:.1f} s)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 20: the command line on the card
# ---------------------------------------------------------------------------
# The run's only cut is the corpus: 16 synthetic tunes of 16 bars (546
# training windows and 79 test windows in folk_4by4nbars_train's split), so
# each trainer takes one epoch of a few steps at the shipped widths.
CLI_TUNES = 16
CLI_EVAL_BATCH = 32  # 79 test windows: batches of 32, 32 and 15
CLI_ARNN_BATCH = 128  # the ARNN trainers' batch: 5 steps of their epoch
# The joint evaluation on the card against the CPU (plain versions), the
# same checkpoints, splits and rsample noise: per model, the relative error
# of the mean loss and the share of scored ticks whose argmax agrees.
CLI_REF = {"loss_rel": 1e-5, "tokens": 0.999}
EVAL_KERNELS = ("encoder_hn", "decode_sampling", "arnn_sampled_decode")


def _all_kernels():
    """{name: wrapper} of the eight kernels' wrappers (their launch counts)."""
    from inpaintnet_tpu_torch.ops import (
        arnn_kernel,
        decode_kernel,
        encoder_kernel,
        gru_kernel,
        gru_train_kernel,
    )

    return {k.__name__: k for k in (
        encoder_kernel.encoder_hn, decode_kernel.decode_sampling,
        encoder_kernel.encoder_hn_int8, decode_kernel.decode_sampling_int8,
        gru_train_kernel.gru_fwd_seq, gru_train_kernel.gru_bwd_seq,
        arnn_kernel.arnn_sampled_decode, gru_kernel.gru_layer_stream)}


def _counted(fn):
    """Run ``fn()`` with every kernel's launch count set to 0. -> (its
    result, {kernel: launches})"""
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in kernels.items()}


def _cli_testers(argv):
    """``cli.test_reconstruction``'s testers of ``argv``, built anew (their
    splits start afresh). -> (loader, the other arguments of its
    ``loss_and_acc_test``, windows)"""
    from inpaintnet_tpu_torch.cli import test_reconstruction as tr

    args = tr.build_parser().parse_args(argv)
    loader, latent, arnn, baseline, ablations = tr.build_testers(args)
    windows = sum(np.asarray(b[0]).shape[0] for b in loader)
    return (loader, latent, arnn, baseline, args.num_target, args.num_models, ablations), windows


def _cli_eval(testers, predictions=None):
    """The joint evaluation's loop over built testers. -> (results, wall s)"""
    from inpaintnet_tpu_torch.cli import test_reconstruction as tr

    loader, latent, arnn, baseline, num_target, num_models, ablations = testers
    if latent.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = tr.loss_and_acc_test(loader, latent, arnn, baseline,
                                   num_target_measures=num_target, num_models=num_models,
                                   ablation_testers=ablations, predictions=predictions)
    return results, time.perf_counter() - t0


def _restart_splits(testers) -> None:
    """The testers' split draws from their start, as new testers' (the
    LatentRNN tester's ``RandomState(seed + 41)`` cuts every split)."""
    latent = testers[1]
    latent._np_rng = np.random.RandomState(latent.seed + 41)


@contextlib.contextmanager
def _recorded_eval_kernels(calls: dict):
    """The models' calls of K1, K2 and K7, each appended to
    ``calls[wrapper name]`` as (wrapper, arguments) before it runs."""
    from inpaintnet_tpu_torch.models import anticipation_rnn, measure_vae

    sites = ((measure_vae, "encoder_hn"), (measure_vae, "decode_sampling_kernel"),
             (anticipation_rnn, "arnn_sampled_decode"))
    saved = [getattr(module, name) for module, name in sites]

    def record(fn):
        def call(*args):
            calls.setdefault(fn.__name__, []).append((fn, args))
            return fn(*args)
        return call

    for (module, name), fn in zip(sites, saved):
        setattr(module, name, record(fn))
    try:
        yield
    finally:
        for (module, name), fn in zip(sites, saved):
            setattr(module, name, fn)


def _device_rows(call) -> tuple:
    """The device activity of one traced ``call()`` (CUDA activity only,
    read from kineto's raw events: parsing ~85,000 launches into
    ``FunctionEvent``s takes the host tens of seconds), traced again while
    none shows. -> (device ms, launches, [(kernel, ms, launches)] by time)"""
    for attempt in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in e.name()):
                ms, n = by_name.get(e.name(), (0.0, 0))
                by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        if by_name:
            break
        print(f"[profile] no device activity recorded (attempt {attempt + 1}); tracing again",
              flush=True)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def phase_cli_train(data: list, card: str) -> None:
    """A corpus, then the five trainers through their entry points at the
    shipped widths, one epoch each on the card."""
    from inpaintnet_tpu_torch.cli import (
        prepare_corpus,
        train_arnn_baseline,
        train_arnn_reg,
        train_inpaintnet,
        train_inpaintnet_ablation,
        train_measure_vae,
    )

    prepare_corpus.main(["synth", "--out_dir", "corpus", "--num_tunes", str(CLI_TUNES),
                         "--num_bars", "16"])
    prepare_corpus.main(["stats", "--corpus_dir", "corpus", "--cache_dir", "cache"])
    train = data + ["--num_epochs", "1", "--no_plot"]
    for name, main, argv in (
            ("MeasureVAE", train_measure_vae.main, train),
            ("LatentRNN", train_inpaintnet.main, train + ["--no_auto_reg"]),
            ("ablation past", train_inpaintnet_ablation.main,
             train + ["--no_auto_reg", "--context_type", "past"]),
            ("ablation future", train_inpaintnet_ablation.main,
             train + ["--no_auto_reg", "--context_type", "future"]),
            # batches of 128: a quarter of the steps, each as host-bound as at 32
            ("ARNN reg", train_arnn_reg.main, train + ["--batch_size", str(CLI_ARNN_BATCH)]),
            ("ARNN baseline", train_arnn_baseline.main,
             train + ["--batch_size", str(CLI_ARNN_BATCH)])):
        t0 = time.perf_counter()
        (loss, acc), launches = _counted(lambda: main(argv))
        if not np.isfinite(loss):
            raise RuntimeError(f"{name}: test loss {loss}")
        print(f"[cli] train {name}: one epoch and its test in {time.perf_counter() - t0:.2f} s,"
              f" test loss {loss:.6f}, accuracy {acc:.4f}; launches "
              f"{ {k: v for k, v in launches.items() if v} } | {card}", flush=True)


def phase_cli_eval(data: list, card: str) -> dict:
    """The joint evaluation through ``cli.test_reconstruction.main`` on the
    card (K1, K2 and K7 must launch), its time, profile and idle share,
    then the same evaluation on the CPU held to ``CLI_REF``; the VAE
    tester over the test split. -> {kernel: launches in the evaluation}"""
    from inpaintnet_tpu_torch.cli import test_reconstruction as tr

    argv = data + ["--include_ablations", "past,future", "--batch_size", str(CLI_EVAL_BATCH)]
    results, launches = _counted(lambda: tr.main(argv))
    if min(launches[k] for k in EVAL_KERNELS) < 1:
        raise RuntimeError(f"the joint eval did not launch K1, K2 and K7: {launches}")
    names = ("latent_rnn", "ablation_past", "ablation_future", "arnn", "arnn_baseline")
    for name in names:
        print(f"[cli-eval] {name}: loss {results[f'{name}_loss']:.6f}, accuracy "
              f"{results[f'{name}_acc']:.4f}, repeat {results.get(f'{name}_acc_repeat', 0):.4f}"
              f", novel {results.get(f'{name}_acc_novel', 0):.4f} | {card}", flush=True)
    print(f"[cli-eval] launches in the eval: {launches}; repeat fraction "
          f"{results.get('repeat_fraction', 0):.4f}", flush=True)

    card_pred, cpu_pred, calls = {}, {}, {}
    testers, windows = _cli_testers(argv)
    got, wall = _cli_eval(testers)
    _restart_splits(testers)
    with _recorded_eval_kernels(calls):
        again, _ = _cli_eval(testers, card_pred)
    if again != got:
        raise RuntimeError("the joint eval's second run on the card differs from its first")
    _restart_splits(testers)
    device_ms, count, rows = _device_rows(lambda: _cli_eval(testers))
    batches = len(testers[0])
    kernel_ms = {name: sum(cuda_ms(lambda: fn(*args), 3) for fn, args in runs)
                 for name, runs in calls.items()}
    print(f"[cli-eval] card: {windows / wall:.1f} windows/s ({wall * 1e3:.1f} ms for {windows} "
          f"windows, {batches} batches), device {device_ms:.2f} ms ({device_ms / batches:.2f} "
          f"ms a batch, {count} launches), idle share {1 - device_ms / (wall * 1e3):.3f} | "
          f"{card}", flush=True)
    print(f"[cli-eval] the eval's kernel calls replayed (CUDA events, wrapper ms summed over "
          f"its calls): " + ", ".join(f"{k} {len(calls[k])} calls {v:.3f} ms"
                                      for k, v in kernel_ms.items()) + f" | {card}", flush=True)
    parts = {}
    for label, key in (("K1 recurrence (gru_fwd_kernel)", "gru_fwd_kernel"),
                       ("K2 (decode_f32_kernel)", "decode_f32_kernel"),
                       ("K7 recurrence (arnn_f32_kernel)", "arnn_f32_kernel"),
                       ("the split GEMM of K1 and K7", "encoder_xw_gemm_split_kernel")):
        found = [(ms, n) for name, ms, n in rows if key in name]
        parts[label] = (round(sum(ms for ms, _ in found), 3), sum(n for _, n in found))
    print(f"[cli-eval] torch.profiler, device ms and launches of the eval's kernels: {parts}",
          flush=True)
    for name, ms, n in rows[:8]:
        print(f"[cli-eval]   {ms:9.3f} ms {n:6d}x  {name[:100]}", flush=True)

    cpu, cpu_wall = _cli_eval(_cli_testers(argv + ["--device", "cpu"])[0], cpu_pred)
    for name in names:
        loss_rel = abs(got[f"{name}_loss"] - cpu[f"{name}_loss"]) / abs(cpu[f"{name}_loss"])
        share = float(np.mean(np.concatenate([a.ravel() for a in card_pred[name]])
                              == np.concatenate([a.ravel() for a in cpu_pred[name]])))
        print(f"[cli-eval] {name} card vs CPU: loss {got[f'{name}_loss']:.7f} / "
              f"{cpu[f'{name}_loss']:.7f} (relative error {loss_rel:.2e}), argmax agrees on "
              f"{share:.5f} of the scored ticks", flush=True)
        if loss_rel > CLI_REF["loss_rel"] or share < CLI_REF["tokens"]:
            raise RuntimeError(f"{name}: the card's joint eval left CLI_REF {CLI_REF}")
    print(f"[cli-eval] the CPU's eval took {cpu_wall:.1f} s", flush=True)

    from inpaintnet_tpu_torch.cli.common import build_vae, standard_datasets
    from inpaintnet_tpu_torch.eval import VAETester

    args = tr.build_parser().parse_args(argv)
    train_ds, test_ds = standard_datasets(args.dataset_name, args.cache_dir, args.corpus_dir)
    tester = VAETester(test_ds, build_vae(args, train_ds, torch.device("cuda")).load())
    _, _, loader = test_ds.data_loaders(batch_size=64, split=(0.01, 0.01))
    tester.loss_and_acc_test(loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, acc), vae_launches = _counted(lambda: tester.loss_and_acc_test(loader))
    vae_s = time.perf_counter() - t0
    print(f"[cli-eval] VAE tester over the test split ({windows * 16} measures, batch 64): "
          f"{vae_s * 1e3:.1f} ms, loss {loss:.6f}, accuracy {acc:.4f}, launches "
          f"{ {k: v for k, v in vae_launches.items() if v} } | {card}", flush=True)
    return {k: launches[k] for k in launches}


def phase_cli_generate(data: list, card: str) -> None:
    """Both generation entry points write MIDI that decodes; K2 launches in
    the batch-1 ``generate``."""
    from inpaintnet_tpu_torch.cli import script_gen_diff_models, script_gen_same_context
    from inpaintnet_tpu_torch.data.midi import read_midi_notes

    same, launches = _counted(lambda: script_gen_same_context.main(
        data + ["--num_generations", "3", "--save_folder", "midi_same"]))
    if launches["decode_sampling"] < 3:
        raise RuntimeError(f"script_gen_same_context: K2 launched {launches}")
    diff = script_gen_diff_models.main(data + ["--num_melodies", "2", "--save_folder",
                                               "midi_diff"])
    for path in same + diff:
        with open(path, "rb") as f:
            if f.read(4) != b"MThd" or not read_midi_notes(path):
                raise RuntimeError(f"{path}: not a MIDI file that decodes")
    print(f"[cli-generate] {len(same)} re-inpaintings and {len(diff)} listening-test files "
          f"written and decoded; launches of the batch-1 generations "
          f"{ {k: v for k, v in launches.items() if v} } | {card}", flush=True)


def phase_cli_server(data: list, card: str) -> None:
    """``python -m inpaintnet_tpu_torch.cli.run_server`` on the trained
    checkpoints: /healthz and one /v1/inpaint answer; then it is stopped."""
    import os
    import re

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "inpaintnet_tpu_torch.cli.run_server",
                             *data, "--port", "0"], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        while port is None:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"run_server ended before serving (rc {proc.poll()})")
            found = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(found.group(1)) if found else None
        up = time.perf_counter() - t0
        if _http(port, "GET", "/healthz")["status"] != "ok":
            raise RuntimeError("/healthz did not answer ok")
        tokens = np.random.default_rng(20).integers(0, 50, (1, 16, 24))
        out = np.asarray(_http(port, "POST", "/v1/inpaint", {
            "tokens": tokens, "start_measure": 6, "num_measures": 4, "seed": 1})["tokens"])
        _check_response(out, tokens, 6, 4)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    print(f"[cli-server] run_server up in {up:.1f} s, /healthz and /v1/inpaint answered, "
          f"stopped | {card}", flush=True)


def phase_cli(card: str) -> dict:
    """Phase 20, in a temporary working directory (the entry points write
    checkpoints/ there). -> {kernel: launches in the joint evaluation}"""
    import os
    import tempfile

    t0 = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            data = ["--corpus_dir", "corpus", "--cache_dir", "cache", "--device", "cuda"]
            phase_cli_train(data, card)
            t1 = time.perf_counter()
            launches = phase_cli_eval(data, card)
            t2 = time.perf_counter()
            phase_cli_generate(data, card)
            phase_cli_server(data, card)
        finally:
            os.chdir(cwd)
    print(f"[cli] phase 20: {time.perf_counter() - t0:.1f} s (corpus and training "
          f"{t1 - t0:.1f} s, evaluation {t2 - t1:.1f} s, generation and server "
          f"{time.perf_counter() - t2:.1f} s)", flush=True)
    return launches


# --- phase 21: the rest of the training surface ------------------------------ #
# K1's training mode at the VAE step's shape: 256 windows x 16 bars = 4,096
# measure rows of 24 ticks, H 512, the encoder's dropout 0.5. Its planted
# fault is the keep mask read at a chunk's local rows, with chunks of
# K1_FAULT_CHUNK rows (four at 4,096). K1's bounds hold it: BOUNDS' h_n max
# and, in bf16, ENCODER_SHARE_BF16.
K1_TRAIN_RATE = 0.5
K1_FAULT_CHUNK = 1024
# The VAE step under INPAINTNET_TRAIN_ENCODER_IMPL=pallas: K1 launches once a
# step (its backward is the eager scan), and K5/K6 only for the decoder's
# GRUs (TRAIN_LAUNCHES less the encoder's 4).
K1_TRAIN_LAUNCHES = 1
ENCODER_K5_LAUNCHES = 4
DP_WORLD = 2  # gloo ranks sharing the one card


@contextlib.contextmanager
def _train_encoder_impl(impl: str):
    """``INPAINTNET_TRAIN_ENCODER_IMPL`` inside the block."""
    import os

    old = os.environ.get("INPAINTNET_TRAIN_ENCODER_IMPL")
    os.environ["INPAINTNET_TRAIN_ENCODER_IMPL"] = impl
    try:
        yield
    finally:
        if old is None:
            del os.environ["INPAINTNET_TRAIN_ENCODER_IMPL"]
        else:
            os.environ["INPAINTNET_TRAIN_ENCODER_IMPL"] = old


@contextlib.contextmanager
def _chunk_local_keep():
    """The planted fault inside the block: K1's staged plain version reads
    each chunk's mask at its local rows (the mask's first) instead of its
    global ones."""
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek

    real = ek.chunk_keep
    ek.chunk_keep = lambda keep, row0, rows: keep[:rows]
    try:
        yield
    finally:
        ek.chunk_keep = real


def _k1_judge(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple:
    """(max abs error, share of elements not bit-equal, within K1's bounds)."""
    err = (got.float() - want.float()).abs().max().item()
    share = (got != want).float().mean().item()
    ok = err <= BOUNDS[dtype]["hn"] and (dtype == torch.float32 or share <= ENCODER_SHARE_BF16)
    return err, share, ok


def phase_k1_train_kernel(card: str) -> dict:
    """K1's training mode (``encoder_hn(keep=, rate=)``) at the VAE step's
    shape in f32 and bf16 against its plain version; the chunk-offset fault
    rejected; its time beside K1 inference at the same rows, the encoder's
    default training forward (K5, four launches) and cuDNN's ``nn.GRU``
    with dropout in train mode (a yardstick: it draws its own masks). ->
    {"bfloat16": entry, "float32": entry}"""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.ops.gru import gru_apply
    from inpaintnet_tpu_torch.utils.timing import device_timeit

    def min_ms(fn, reps):
        """The least of ``reps`` single calls, CUDA events (utils.timing)."""
        return device_timeit(fn, iters=1, warmup=1, reps=reps) * 1e3

    _, vae, _ = build_flagship(seed=0, device="cuda")
    enc = vae.params()["encoder"]
    rows, hidden = TRAIN_WINDOWS * N_BARS, vae.encoder.rnn_hidden_size
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(0, VOCAB, (rows, 24)).astype(np.int32)).cuda()
    keep = torch.rand((rows, 24, 2 * hidden), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(21)) >= K1_TRAIN_RATE
    report = {}
    for label, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        gru = cast_params(enc["gru"], "cuda", dtype)
        table = enc["embedding"]["table"].to(dtype).contiguous()
        hn_k = ek.encoder_hn(gru, table, tokens, keep=keep, rate=K1_TRAIN_RATE)
        hn_c = ek.encoder_hn(gru, table, tokens, max_chunk_rows=K1_FAULT_CHUNK, keep=keep,
                             rate=K1_TRAIN_RATE)
        hn_p = ek.encoder_hn_reference(gru, table, tokens, keep, K1_TRAIN_RATE)
        with _chunk_local_keep():
            planted = ek.encoder_hn_staged_reference(gru, table, tokens, keep, K1_TRAIN_RATE,
                                                     max_chunk_rows=K1_FAULT_CHUNK)
        torch.cuda.synchronize()
        err, share, ok = _k1_judge(hn_k, hn_p, dtype)
        c_err, c_share, c_ok = _k1_judge(hn_c, hn_p, dtype)
        f_err, f_share, f_ok = _k1_judge(hn_c, planted, dtype)
        print(f"[k1-train] {label}: {rows} rows, rate {K1_TRAIN_RATE}: h_n max_abs_err {err:.3e} "
              f"on {share:.4f} of elements; {rows // K1_FAULT_CHUNK} chunks {c_err:.3e} on "
              f"{c_share:.4f}; planted fault, the mask at the chunk's local rows: {f_err:.3e} on "
              f"{f_share:.4f} (bounds {BOUNDS[dtype]['hn']:.0e}"
              f"{'' if dtype == torch.float32 else f', share {ENCODER_SHARE_BF16}'}) | {card}",
              flush=True)
        if not (ok and c_ok):
            raise RuntimeError(f"K1's training mode ({label}) disagrees with its plain version")
        if f_ok:
            raise RuntimeError(f"the planted chunk-offset fault passes K1's {label} bounds")
        del hn_c, planted
        # the default training route's encoder GRU (K5's four launches, the
        # parameters requiring grad as in a step) and cuDNN's, timed beside K1
        leaves = [[{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in layer]
                  for layer in gru]
        emb = table[tokens.long()]

        def default_route():
            return gru_apply(leaves, emb, last_outputs=False, dropout=K1_TRAIN_RATE, train=True,
                             dropout_masks=[keep])[1]

        gk.gru_fwd_seq.launches = 0
        default_route()
        if gk.gru_fwd_seq.launches != ENCODER_K5_LAUNCHES:
            raise RuntimeError(f"the default route launched K5 {gk.gru_fwd_seq.launches} times")
        net = torch.nn.GRU(emb.shape[-1], hidden, 2, batch_first=True, bidirectional=True,
                           dropout=K1_TRAIN_RATE).to(device="cuda", dtype=dtype).train()
        net.flatten_parameters()  # one contiguous weight buffer, as cuDNN wants it
        with torch.no_grad():
            cudnn_ms = min_ms(lambda: net(emb), 5)
        ops = encoder_ops(rows, 24, hidden)
        moved = nbytes(gru, table, tokens, keep, hn_k)
        entry = {"max_abs_err": err, "ms": min_ms(lambda: ek.encoder_hn(
                     gru, table, tokens, keep=keep, rate=K1_TRAIN_RATE), 5),
                 "plain_ms": min_ms(lambda: ek.encoder_hn_reference(
                     gru, table, tokens, keep, K1_TRAIN_RATE), 2),
                 **bound_of(ops if dtype == torch.bfloat16 else 6 * ops, "bf16", moved),
                 "library_ms": cudnn_ms,
                 "inference_ms": min_ms(lambda: ek.encoder_hn(gru, table, tokens), 5),
                 "default_route_ms": min_ms(default_route, 5), "rows": rows}
        if dtype == torch.float32:
            entry["bound_f32_fma_ms"] = bound_of(ops, "f32", moved)["bound_ms"]
        print(f"[time] encoder_hn training mode {label} (each the least of its calls): kernel "
              f"{entry['ms']:.3f} ms, plain "
              f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms "
              f"({entry['bound_by']}); K1 inference {entry['inference_ms']:.3f} ms; the default "
              f"route's forward (K5 x{ENCODER_K5_LAUNCHES}) {entry['default_route_ms']:.3f} ms; "
              f"cuDNN nn.GRU(dropout {K1_TRAIN_RATE}, train) {cudnn_ms:.3f} ms | {card}",
              flush=True)
        report[label] = entry
        del leaves, emb, net, hn_k, hn_p
        torch.cuda.empty_cache()
    return report


def phase_k1_trainer(card: str) -> int:
    """The VAE trainer under ``INPAINTNET_TRAIN_ENCODER_IMPL=pallas``: phase
    9's step on the card against the CPU (K1 launched on the card), then the
    full-width trainer in f32 and bf16, each step's launches asserted (K1
    once, K5/K6 only for the decoder), timed beside the default route in
    turns. -> K1's launches in the full-width steps under the switch"""
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.train.data import ArrayDataset
    from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer
    from inpaintnet_tpu_torch.utils.profiling import StepTimer

    ek.encoder_hn.launches = 0
    with _train_encoder_impl("pallas"):
        phase_train_reference(card)
    if ek.encoder_hn.launches < 2:
        raise RuntimeError(f"phase 9's step under the switch launched K1 {ek.encoder_hn.launches}"
                           " times")
    model = MeasureVAE(VocabOnlyDataset(VOCAB), device="cuda", seed=0)
    windows = np.random.default_rng(7).integers(
        0, VOCAB, (TRAIN_WINDOWS, 1, N_BARS * 24)).astype(np.int32)
    data = ArrayDataset((windows,), N_BARS)
    rows = TRAIN_WINDOWS * N_BARS
    kernels = (ek.encoder_hn, gk.gru_fwd_seq, gk.gru_bwd_seq)
    total = 0
    for compute in (None, "bfloat16"):
        label = compute or "float32"
        trainers = {impl: VAETrainer(data, model, lr=1e-4, device="cuda", compute_dtype=compute)
                    for impl in ("xla", "pallas")}
        batch = trainers["xla"].process_batch_data((windows,))
        # the card's time of a step: StepTimer synchronises at its start and
        # end; the first step of each coin is left out
        timers = {impl: StepTimer(items_per_step=rows, warmup=2, device="cuda")
                  for impl in trainers}
        for i, coin in enumerate((True, False) * 3):
            for impl in (("xla", "pallas") if i % 2 == 0 else ("pallas", "xla")):
                before = [k.launches for k in kernels]
                with _train_encoder_impl(impl), timers[impl]:
                    loss = trainers[impl].train_step(batch, coin=coin)[0].item()
                got = [k.launches - b for k, b in zip(kernels, before)]
                want = ([K1_TRAIN_LAUNCHES] + [TRAIN_LAUNCHES[coin] - ENCODER_K5_LAUNCHES] * 2
                        if impl == "pallas" else [0] + [TRAIN_LAUNCHES[coin]] * 2)
                if got != want or not np.isfinite(loss):
                    raise RuntimeError(f"{label} step {i} under {impl} (coin {coin}): launches "
                                       f"K1/K5/K6 {got}, expected {want}; loss {loss}")
                if impl == "pallas":
                    total += got[0]
        ms = {impl: timer.mean_s * 1e3 for impl, timer in timers.items()}
        print(f"[k1-trainer] {label} compute, {rows} measure rows a step: "
              f"INPAINTNET_TRAIN_ENCODER_IMPL=pallas {ms['pallas']:.2f} ms/step (K1 once, K5/K6 "
              f"for the decoder), default {ms['xla']:.2f} ms/step (K5/K6 {TRAIN_LAUNCHES}), "
              f"mean of 4 steps each, both coins, in turns | {card}", flush=True)
        del trainers, batch
        torch.cuda.empty_cache()
    return total


def _adam_steps(params, steps) -> tuple:
    """``steps`` Adam steps (lr 1e-3) of a cross-entropy loss through
    ``step(params)`` -> logits (B, T, V), tokens; -> (the parameters
    after, every step's tokens)."""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.train.metrics import mean_crossentropy_loss

    leaves = [p for _, p in iter_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    tokens = []
    for step, target in steps:
        opt.zero_grad(set_to_none=True)
        logits, samples = step(params)
        mean_crossentropy_loss(logits, target).backward()
        opt.step()
        tokens.append(samples.cpu())
    return [p.detach().cpu() for p in leaves], tokens


def phase_flat_decoders(card: str) -> None:
    """``SRDecoder`` (multinomial sampling), ``SRDecoderNoInput`` and
    ``HierarchicalDecoder``'s multinomial decode: two Adam steps each (one a
    coin) on the card against the CPU, f32, H 64, the same parameters,
    dropout masks and Gumbel noise; the tokens of each step equal, the
    parameters held to ``TRAIN_REF``."""
    from inpaintnet_tpu_torch.models.measure_vae import (
        HierarchicalDecoder,
        SRDecoder,
        SRDecoderNoInput,
    )
    from inpaintnet_tpu_torch.train.trainer import trainable_copy

    geometry = dict(note_embedding_dim=10, num_notes=VOCAB, z_dim=16, num_layers=2,
                    rnn_hidden_size=64)
    batch, ticks, hidden = 32, 24, 64
    rng = np.random.default_rng(22)
    z = torch.from_numpy(rng.standard_normal((batch, 16)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, VOCAB, (batch, ticks)))
    gumbel = torch.from_numpy(rng.gumbel(size=(batch, ticks, VOCAB)).astype(np.float32))

    def keep(*shape):
        return torch.from_numpy(rng.random(shape) >= 0.5)

    for name, cls, dropout in (("SRDecoder multinomial", SRDecoder, 0.5),
                               ("SRDecoderNoInput", SRDecoderNoInput, 0.5),
                               ("HierarchicalDecoder multinomial", HierarchicalDecoder, 0.0)):
        out = {}
        tf_masks = [keep(batch, ticks, hidden)]
        seq_masks = [[keep(batch, hidden)] for _ in range(ticks)]
        for device in ("cuda", "cpu"):
            dec = cls(dropout=dropout, device="cpu", **geometry)
            dec.sampling = "multinomial"
            params = trainable_copy(dec.init_params(np.random.default_rng(23)), device)
            zd, td, gd = z.to(device), target.to(device), gumbel.to(device)
            tf_d = [m.to(device) for m in tf_masks]
            seq_d = [[m.to(device) for m in ms] for ms in seq_masks]

            def step_of(coin, dec=dec, zd=zd, td=td, gd=gd, tf_d=tf_d, seq_d=seq_d):
                if cls is HierarchicalDecoder:
                    if coin:
                        return lambda p: dec.decode_teacher_forced(p, zd, td, train=True,
                                                                   gumbel=gd)
                    return lambda p: dec.decode_sampling(p, zd, train=True, gumbel=gd)
                return lambda p: dec.apply(p, zd, td, train=True, coin=coin,
                                           dropout_masks=tf_d if coin or cls is SRDecoderNoInput
                                           else seq_d, gumbel=gd)

            out[device] = _adam_steps(params, [(step_of(c), td) for c in (True, False)])
        (p_c, t_c), (p_p, t_p) = out["cuda"], out["cpu"]
        same_tokens = all(torch.equal(a.long(), b.long()) for a, b in zip(t_c, t_p))
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p_c, p_p)])
        print(f"[flat-decoders] {name}: two Adam steps (coin True, False), card vs CPU: tokens "
              f"equal {same_tokens}, params max {diff.max().item():.3e} (bound "
              f"{TRAIN_REF['param_max']:.0e}), mean {diff.mean().item():.3e} (bound "
              f"{TRAIN_REF['param_mean']:.0e}) | {card}", flush=True)
        if not (same_tokens and diff.max().item() <= TRAIN_REF["param_max"]
                and diff.mean().item() <= TRAIN_REF["param_mean"]):
            raise RuntimeError(f"{name}: the card's Adam steps disagree with the CPU's")


def _dp_vae_run(mesh=None, steps: int = 2) -> tuple:
    """The full-width VAE trainer (dropout 0; the rsample noise and the coin
    injected, one coin a step) on ``TRAIN_WINDOWS`` windows of ``N_BARS``
    bars, ``steps`` Adam steps. -> ({path: parameter}, last loss, the last
    step's wall ms)"""
    from inpaintnet_tpu_torch.models.base import flatten_params
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
    from inpaintnet_tpu_torch.train.data import ArrayDataset
    from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

    rng = np.random.default_rng(24)
    windows = rng.integers(0, VOCAB, (TRAIN_WINDOWS, 1, N_BARS * 24)).astype(np.int32)
    model = MeasureVAE(VocabOnlyDataset(VOCAB), encoder_dropout_prob=0.0,
                       decoder_dropout_prob=0.0, device="cuda", seed=0)
    tr = VAETrainer(ArrayDataset((windows,), N_BARS), model, lr=1e-4, device="cuda", mesh=mesh)
    batch = tr.process_batch_data((windows,))
    loss = wall = None
    for step in range(steps):
        eps = torch.from_numpy(rng.standard_normal((batch.shape[0], model.latent_space_dim))
                               .astype(np.float32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.train_step(batch, eps=eps, coin=step % 2 == 0)[0].item()
        wall = (time.perf_counter() - t0) * 1e3
    return flatten_params(tr.params), loss, wall


def _dp_rank(rank: int, world: int, port: int, out_path: str) -> None:
    """One gloo rank on the shared card: ``_dp_vae_run`` over the world."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        params, loss, wall = _dp_vae_run()
        if rank == 0:
            np.savez(out_path, loss=loss, wall=wall, **params)
    finally:
        dist.destroy_process_group()


def _same_params(a: dict, b: dict) -> tuple:
    diff = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in b])
    return float(diff.max()), float(diff.mean())


def phase_data_parallel(model, card: str) -> None:
    """Two gloo ranks sharing the card train the full-width VAE two steps
    (4,096 global rows, dropout 0, the same injected draws) and must equal
    one process within ``TRAIN_REF``; a world-1 NCCL group's step (its
    all-reduce runs) too; the bf16 engine on a mesh naming the card twice
    serves batch 2048 (6/4/6) through ``inpaint_hetero`` bit-equal to the
    engine without a mesh. This checks correctness: ranks on one card share
    it, so their times say nothing of scaling."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from inpaintnet_tpu_torch.parallel.mesh import Mesh, free_port, make_mesh
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    t0 = time.perf_counter()
    one, one_loss, one_wall = _dp_vae_run()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "rank0.npz")
        mp.start_processes(_dp_rank, args=(DP_WORLD, free_port(), out), nprocs=DP_WORLD,
                           join=True, start_method="spawn")
        with np.load(out) as z:
            two = {k: z[k] for k in z.files if k not in ("loss", "wall")}
            two_loss, two_wall = float(z["loss"]), float(z["wall"])
    t2 = time.perf_counter()
    p_max, p_mean = _same_params(two, one)
    print(f"[dp] {DP_WORLD} gloo ranks on one card vs one process, full-width VAE, "
          f"{TRAIN_WINDOWS * N_BARS} global rows, 2 Adam steps: last loss {two_loss:.6f} / "
          f"{one_loss:.6f}, params max {p_max:.3e} (bound {TRAIN_REF['param_max']:.0e}), mean "
          f"{p_mean:.3e} (bound {TRAIN_REF['param_mean']:.0e}); the second step's wall: one "
          f"process {one_wall:.2f} ms, rank 0 of two {two_wall:.2f} ms (half the rows each, "
          f"both ranks on one card, gloo reducing through the host: no scaling measured); one "
          f"process {t1 - t0:.1f} s, the two ranks {t2 - t1:.1f} s with their start-up | {card}",
          flush=True)
    if not (p_max <= TRAIN_REF["param_max"] and p_mean <= TRAIN_REF["param_mean"]):
        raise RuntimeError("two data-parallel ranks disagree with one process")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        nccl, nccl_loss, _ = _dp_vae_run(
            mesh=Mesh([torch.device("cuda", 0)], 1, distributed=True), steps=1)
    finally:
        dist.destroy_process_group()
    first, first_loss, _ = _dp_vae_run(steps=1)
    n_max, n_mean = _same_params(nccl, first)
    print(f"[dp] world-1 NCCL group, one step (its all-reduce run): loss {nccl_loss:.6f} / "
          f"{first_loss:.6f}, params max {n_max:.3e}, mean {n_mean:.3e} | {card}", flush=True)
    if not (n_max <= TRAIN_REF["param_max"] and n_mean <= TRAIN_REF["param_mean"]):
        raise RuntimeError("the NCCL step disagrees with the step without a group")
    rng = np.random.default_rng(25)
    tokens, start, num = _request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE)
    reqs = [{"tokens": tokens, "start_measure": start, "num_measures": num, "seed": 5}]
    single = InpaintingEngine(model, batch_buckets=(BATCH,), dtype="bfloat16")
    sharded = InpaintingEngine(model, batch_buckets=(BATCH,), dtype="bfloat16",
                               mesh=make_mesh(devices=["cuda", "cuda"]))
    a, b = single.inpaint_hetero(reqs)[0], sharded.inpaint_hetero(reqs)[0]
    _check_response(b, tokens, start, num)
    equal = np.array_equal(a, b)
    print(f"[dp] bf16 engine, mesh of the card named twice, batch {BATCH} "
          f"({N_PAST}/{N_TARGET}/{N_FUTURE}) inpaint_hetero: bit-equal to the engine without a "
          f"mesh {equal} (token share {(a == b).mean():.6f}) | {card}", flush=True)
    if not equal:
        raise RuntimeError("the mesh engine's inpaint_hetero differs from the engine's")


def phase_training_surface(model, card: str) -> dict:
    """Phase 21. -> K1's training-mode entry of the kernels line."""
    t0 = time.perf_counter()
    report = phase_k1_train_kernel(card)
    launches = phase_k1_trainer(card)
    phase_flat_decoders(card)
    phase_data_parallel(model, card)
    print(f"[phase21] {time.perf_counter() - t0:.1f} s", flush=True)
    entry = report["bfloat16"]
    return {**entry, "launches": launches, "f32": report["float32"]}


# --- phase 22: the mesh's "model" axis ---------------------------------------- #
# Two gloo ranks on the one card at model=2 (a 1 x 2 world) against one
# process: the flagship MeasureVAE forward (TP_VAE_ROWS measures) in bf16 and
# f32 through K1 and K2 on gathered gate matrices, bit-equal; the flagship
# dry-run LatentRNN step (TP_WINDOWS windows of 16 bars, TP_STEPS Adam steps,
# dropout 0.5: both ranks and the one process draw the same masks) through
# K5 and K2, its parameters within TP_PARAM_ATOL (the gather is exact, so
# bit-equality is expected); the trainer matrix's steps, whose ARNN
# validation runs K7. Launches on each rank equal one process's.
TP_VAE_ROWS = 2048
TP_WINDOWS = 32
TP_STEPS = 2
TP_PARAM_ATOL = 1e-6
TP_KERNELS = ("encoder_hn", "decode_sampling", "gru_fwd_seq", "arnn_sampled_decode")


def _tp_run(mesh) -> dict:
    """Phase 22's work on ``mesh`` (one process's or a rank's). -> flat
    numpy results: outputs, parameters, losses, walls, launches, bytes"""
    import tempfile

    from inpaintnet_tpu_torch.parallel import dryrun
    from inpaintnet_tpu_torch.parallel.mesh import gate_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    vae, model = dryrun.build_models(**dryrun.FLAGSHIP, device="cuda")
    rng = np.random.default_rng(26)
    tokens = torch.from_numpy(rng.integers(0, VOCAB, (TP_VAE_ROWS, 24)).astype(np.int32)).cuda()
    eps = torch.from_numpy(rng.standard_normal((TP_VAE_ROWS, vae.latent_space_dim)).astype(
        np.float32)).cuda()
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        ((weights, samples, *_), params), launches = _counted(
            lambda d=dtype: dryrun.sharded_vae_forward(
                mesh, vae, tokens, dtype=d, eps=eps,
                generator=torch.Generator("cuda").manual_seed(0)))
        torch.cuda.synchronize()
        out[f"vae_{name}_weights"] = weights.float().cpu().numpy()
        out[f"vae_{name}_samples"] = samples.cpu().numpy()
        out[f"vae_{name}_launches"] = [launches[k] for k in TP_KERNELS]
        out[f"vae_{name}_bytes"] = gate_bytes(params)
    step = dryrun.ShardedLatentRNNStep(mesh, model)
    batch = dryrun.example_batch(TP_WINDOWS, vocab=VOCAB)
    walls, losses = [], []

    def steps():
        for _ in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step.step(batch)[0].item())
            walls.append((time.perf_counter() - t0) * 1e3)

    _, launches = _counted(steps)
    out.update({f"latent/{k}": v for k, v in step.full_params().items()})
    out["latent_losses"], out["latent_walls"] = losses, walls
    out["latent_launches"] = [launches[k] for k in TP_KERNELS]
    for key, (held, whole) in step.gate_bytes().items():
        out[f"latent_bytes_{key}"] = [held, whole]
    with tempfile.TemporaryDirectory() as workdir:
        matrix, launches = _counted(lambda: dryrun.check_trainer_matrix(mesh, "cuda", workdir))
    out["matrix_losses"] = [loss for _, loss in matrix]
    out["matrix_launches"] = [launches[k] for k in TP_KERNELS]
    return out


def _tp_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One gloo rank of a 1 x ``world`` world on the shared card."""
    import torch.distributed as dist

    from inpaintnet_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = _tp_run(make_mesh(model=world))
        np.savez(str(Path(out_dir) / f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def phase_tensor_parallel(card: str) -> dict:
    """Phase 22. -> {kernel: launches on the sharded path, rank 0's}"""
    import tempfile

    import torch.multiprocessing as mp

    from inpaintnet_tpu_torch.parallel.mesh import free_port, make_mesh

    t0 = time.perf_counter()
    one = _tp_run(make_mesh(devices=["cuda"]))
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_tp_rank, args=(DP_WORLD, free_port(), tmp), nprocs=DP_WORLD,
                           join=True, start_method="spawn")
        ranks = []
        for r in range(DP_WORLD):
            with np.load(str(Path(tmp) / f"rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
    t2 = time.perf_counter()
    latent = [k for k in one if k.startswith("latent/")]
    for r, got in enumerate(ranks):
        for name in ("bf16", "f32"):
            equal = all(np.array_equal(got[f"vae_{name}_{k}"], one[f"vae_{name}_{k}"])
                        for k in ("weights", "samples"))
            held, whole = got[f"vae_{name}_bytes"]
            print(f"[tp] rank {r} of a 1x{DP_WORLD} gloo world on one card, flagship "
                  f"MeasureVAE forward {name}, {TP_VAE_ROWS} rows: bit-equal to one process "
                  f"{equal}; launches {_launch_dict(got[f'vae_{name}_launches'])} "
                  f"(one process {_launch_dict(one[f'vae_{name}_launches'])}); gate "
                  f"bytes {held} of {whole} | {card}", flush=True)
            if not equal or held * DP_WORLD != whole:
                raise RuntimeError(f"rank {r}: the sharded {name} forward is not one process's")
            _same_launches(got[f"vae_{name}_launches"], one[f"vae_{name}_launches"],
                           ("encoder_hn", "decode_sampling"), f"rank {r} {name} forward")
        diff = max(float(np.abs(got[k] - one[k]).max()) for k in latent)
        walls = got["latent_walls"]
        print(f"[tp] rank {r}: flagship LatentRNN step, {TP_WINDOWS} windows x {N_BARS} bars, "
              f"{TP_STEPS} Adam steps: losses {got['latent_losses'].tolist()} (one process "
              f"{one['latent_losses']}), params max diff {diff:.3e} (bound {TP_PARAM_ATOL:.0e}); "
              f"launches {_launch_dict(got['latent_launches'])} (one process "
              f"{_launch_dict(one['latent_launches'])}); the last step's wall "
              f"{walls[-1]:.2f} ms (one process {one['latent_walls'][-1]:.2f} ms; both ranks "
              f"share the card, gloo gathers through the host: no target); gate bytes "
              + ", ".join(f"{k} {got[f'latent_bytes_{k}'][0]} of {got[f'latent_bytes_{k}'][1]}"
                          for k in ("latent_rnn", "vae", "adam_moments")) + f" | {card}",
              flush=True)
        if diff > TP_PARAM_ATOL:
            raise RuntimeError(f"rank {r}: the sharded LatentRNN step disagrees")
        for k in ("latent_rnn", "vae", "adam_moments"):
            held, whole = got[f"latent_bytes_{k}"]
            if held * DP_WORLD != whole:
                raise RuntimeError(f"rank {r}: holds {held} of {whole} {k} gate bytes")
        _same_launches(got["latent_launches"], one["latent_launches"],
                       ("decode_sampling", "gru_fwd_seq"), f"rank {r} LatentRNN step")
        print(f"[tp] rank {r}: trainer matrix losses {got['matrix_losses'].tolist()} (one "
              f"process {one['matrix_losses']}); launches "
              f"{_launch_dict(got['matrix_launches'])} | {card}", flush=True)
        _same_launches(got["matrix_launches"], one["matrix_launches"],
                       ("arnn_sampled_decode",), f"rank {r} trainer matrix")
    print(f"[phase22] {time.perf_counter() - t0:.1f} s (one process {t1 - t0:.1f} s, the "
          f"two ranks {t2 - t1:.1f} s with their start-up)", flush=True)
    totals = [sum(x) for x in zip(*(ranks[0][f"{k}_launches"] for k in
                                    ("vae_bf16", "vae_f32", "latent", "matrix")))]
    return _launch_dict(totals)


def _launch_dict(counts) -> dict:
    return {k: int(n) for k, n in zip(TP_KERNELS, counts)}


def _same_launches(got, want, kernels, label: str) -> None:
    """Each of ``kernels`` launched, as often as one process launches it."""
    got, want = _launch_dict(got), _launch_dict(want)
    for k in kernels:
        if got[k] == 0 or got[k] != want[k]:
            raise RuntimeError(f"{label}: {k} launched {got[k]} times, one process {want[k]}")


# Phase 23: the engines' CUDA-graph route against their eager route
GRAPH_BUCKETS = (1, 8, BATCH)
GRAPH_MESH_BUCKETS = (2, 8, BATCH)  # a mesh of two shards takes even buckets only
GRAPH_ARNN_BUCKETS = (1, ARNN_BATCH)
# the hand-written kernels' names (csrc/*.cu, *.cuh), as a trace names them
OWN_KERNELS = ("encoder_rec_kernel", "encoder_xw_gemm_kernel", "encoder_xw_gemm_split_kernel",
               "decode_kernel", "decode_f32_kernel", "decode_i8_kernel", "gru_layer_kernel",
               "gru_fwd_kernel", "gru_bwd_kernel", "arnn_kernel", "arnn_f32_kernel",
               "arnn_decode_kernel")


@contextlib.contextmanager
def _route(engine, graphs: bool):
    """The engine on the graph route (``graphs``) or the eager one inside
    the block; its own route after."""
    old = engine.graphs
    engine.graphs = graphs
    try:
        yield
    finally:
        engine.graphs = old


def _on_route(engine, graphs: bool, call):
    """``call`` as a function that runs it on the graph route (``graphs``)
    or the eager one."""
    def run():
        with _route(engine, graphs):
            return call()
    return run


def _route_name(engine) -> str:
    return "graphs" if engine.graphs else "eager"


def _own_kernels(call, want: int = 0, seen: dict | None = None) -> dict:
    """{hand-written kernel: launches} of one ``call()`` by ``torch.profiler``
    traces: the function name of each device row whose name is one of
    ``OWN_KERNELS`` (``decode_kernel`` is not ``arnn_decode_kernel``). A
    trace may lose a kernel (the same call has lost the same one in three
    traces running) but shows none that did not run, so each kernel counts
    its most launches over the traces, and ``seen`` (an earlier reading of
    the same call) is merged in. Traced again, up to ``OWN_TRACES`` times in
    all, while the counts sum to fewer than ``want``."""
    import re

    got = dict(seen or {})
    for _ in range(OWN_TRACES):
        once = {}
        for name, _, count in _profile_step(call)[2]:
            m = re.search(r"\b(\w+_kernel)\b", name)
            if m and m.group(1) in OWN_KERNELS:
                once[m.group(1)] = once.get(m.group(1), 0) + count
        got.update({k: max(n, got.get(k, 0)) for k, n in once.items()})
        if sum(got.values()) >= want:
            break
    return got


# the most traces `_own_kernels` takes of one call (six running once all
# lost the call's first kernel)
OWN_TRACES = 12


def _same_kernels(calls) -> dict:
    """{route: ``_own_kernels``} of each (route, call) in ``calls``, traced
    again, merged with the earlier readings, while the readings differ (a
    trace that lost a kernel), up to ``OWN_TRACES`` rounds."""
    kernels = {}
    for _ in range(OWN_TRACES):
        for key, call in calls:
            kernels[key] = _own_kernels(call, seen=kernels.get(key))
        if len({tuple(sorted(k.items())) for k in kernels.values()}) == 1:
            break
    return kernels


def _same_tokens(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_tokens(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and np.array_equal(a, b)


def _check_routes(engine, label: str, calls, totals: dict) -> None:
    """Each (name, call) on the eager route, then on the graph route twice
    (the key's capture, then a replay): the replay's tokens bit-equal to
    the eager call's and its launches by wrapper equal to the eager call's;
    the replay's launches added to ``totals``."""
    for name, call in calls:
        with _route(engine, False):
            eager, n_eager = _counted(call)
        with _route(engine, True):
            call()
            graph, n_graph = _counted(call)
        if not _same_tokens(graph, eager):
            raise RuntimeError(f"{label} {name}: the graph route's tokens differ from the eager "
                               "route's")
        if n_graph != n_eager:
            raise RuntimeError(f"{label} {name}: a replay launched {n_graph}, the eager call "
                               f"{n_eager}")
        for k, n in n_graph.items():
            totals[k] = totals.get(k, 0) + n
    print(f"[graphs] {label}: {len(calls)} calls, the graph route's tokens and launches equal "
          "the eager route's", flush=True)


def _latent_graph_calls(engine, rng, buckets) -> tuple:
    """Every method at each bucket (a batch of the bucket's rows, 6/4/6),
    and ``interpolate`` unless the model is autoregressive. -> (calls, the
    largest bucket's request, the first bucket's)"""
    calls, requests = [], {}
    for b in buckets:
        tokens, start, num = _request(rng, b, N_PAST, N_TARGET, N_FUTURE)
        requests[b] = (tokens, start, num)
        hetero = [{"tokens": tokens, "start_measure": start, "num_measures": num, "seed": 11}]
        calls += [
            (f"inpaint batch {b}", lambda t=tokens, s=start, n=num: engine.inpaint(t, s, n,
                                                                                 seed=11)),
            (f"inpaint_hetero batch {b}", lambda h=hetero: engine.inpaint_hetero(h)),
            (f"inpaint_variations batch {b} x 2",
             lambda t=tokens, s=start, n=num: engine.inpaint_variations(t, s, n, 2, seed=11)),
        ]
    if not engine.model.auto_reg:
        a, z = requests[buckets[0]][0][0, 0], requests[buckets[-1]][0][-1, -1]
        calls.append(("interpolate 8 points", lambda: engine.interpolate(a, z, 8)))
    return calls, requests[buckets[-1]], requests[buckets[0]]


def _graph_times(engine, label: str, big, one, rows: int, span: int, units: str,
                 card: str) -> None:
    """The batch-``rows`` wall and rate (``span`` ``units`` a row) and the
    batch-1 p50 / p90 on both routes, in turns (eager, graphs, graphs,
    eager); a profile of the graph route's batch-1 call and big one (a
    trace of an eager ARNN call's ~25,000 launches takes many seconds)."""
    walls = {False: [], True: []}
    lats = {False: [], True: []}
    for graphs in (False, True, True, False):
        with _route(engine, graphs):
            walls[graphs].append(cuda_ms(big, 2))
            lats[graphs].extend(cuda_ms(one, 1) for _ in range(6))
    for graphs in (False, True):
        wall, lat = float(np.median(walls[graphs])), lats[graphs]
        route = "graphs" if graphs else "eager"
        print(f"[time] graphs {label} {route}: batch {rows} {wall:.2f} ms per call, "
              f"{rows * span / (wall / 1e3):.1f} {units}/s; batch 1 p50 {np.median(lat):.2f} "
              f"ms (p90 {np.percentile(lat, 90):.2f} ms) | {card}", flush=True)
        if graphs:
            _profile_line(f"graphs {label} {route} batch 1", one, float(np.median(lat)), card,
                          top=4)
            _profile_line(f"graphs {label} {route} batch {rows}", big, wall, card, top=4)


def _graph_keys_line(engine, label: str, card: str) -> None:
    graphs = engine._graphs
    caps = [graphs[k].capture_s for k in graphs.keys()]
    warms = [graphs[k].warm_s for k in graphs.keys()]
    print(f"[graphs] {label}: {len(caps)} keys captured, capture {np.median(caps):.3f} s a key "
          f"(max {max(caps):.3f} s; the eager run before it {np.median(warms):.3f} s, max "
          f"{max(warms):.3f} s); the graphs hold {graphs.held_bytes() / 2**30:.3f} GiB | {card}",
          flush=True)


def phase_graphs(model, arnn, card: str) -> dict:
    """Phase 23. -> {kernel wrapper: launches of the graph route's replays}"""
    from inpaintnet_tpu_torch.graphs import GraphCaptureError, GraphSet
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.parallel.mesh import make_mesh
    from inpaintnet_tpu_torch.serve import InpaintingEngine
    from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

    t0 = time.perf_counter()
    try:
        InpaintingEngine(model, dtype="bfloat16", device="cpu", graphs=True)
    except ValueError as e:
        print(f"[graphs] graphs=True on a CPU engine raises: {e}", flush=True)
    else:
        raise RuntimeError("graphs=True on a CPU engine did not raise")
    x = torch.ones(8, device="cuda")

    def synced(x, *, generator=None):
        if torch.cuda.is_current_stream_capturing():
            x.sum().item()  # the planted host synchronisation
        return x * 2
    try:
        GraphSet().call(("planted host sync",), torch.device("cuda"), synced, (x,))
    except GraphCaptureError as e:
        print(f"[graphs] a planted host sync inside a capture raises: {str(e)[:160]}",
              flush=True)
    else:
        raise RuntimeError("a host sync inside a capture did not raise")

    totals = {}
    _, _, ar_model = build_flagship(seed=0, device="cuda", auto_reg=True)
    configs = [("bf16 xla", model, "bfloat16", "xla", None),
               ("bf16 pallas", model, "bfloat16", "pallas", None),
               ("int8", model, "int8", "xla", None),
               ("f32 pallas", model, "float32", "pallas", None),
               ("autoregressive bf16 pallas", ar_model, "bfloat16", "pallas", None),
               ("mesh bf16 (the card twice)", model, "bfloat16", "xla",
                make_mesh(devices=["cuda", "cuda"]))]
    for label, m, dtype, impl, mesh in configs:
        t_engine = time.perf_counter()
        buckets = GRAPH_BUCKETS if mesh is None else GRAPH_MESH_BUCKETS
        engine = InpaintingEngine(m, batch_buckets=buckets, dtype=dtype, mesh=mesh,
                                  device=None if mesh is not None else "cuda")
        with gru_impl_scope(impl):
            calls, big, one = _latent_graph_calls(engine, np.random.default_rng(23), buckets)
            _check_routes(engine, label, calls, totals)
            big_call = lambda: engine.inpaint(*big, seed=5)  # noqa: E731
            one_call = lambda: engine.inpaint(*one, seed=5)  # noqa: E731
            kernels = _same_kernels([(graphs, _on_route(engine, graphs, one_call))
                                     for graphs in (False, True)])
            print(f"[graphs] {label}: the profiler names the same hand-written kernels in one "
                  f"replay as in one eager call: {kernels[True] == kernels[False]} "
                  f"{kernels[True]}", flush=True)
            if kernels[True] != kernels[False] or not kernels[True]:
                raise RuntimeError(f"{label}: a replay's hand-written kernels {kernels[True]} "
                                   f"differ from the eager call's {kernels[False]}")
            if mesh is None:  # shards sharing one card time nothing of a mesh
                _graph_times(engine, label, big_call, one_call, big[0].shape[0], N_TARGET,
                             "measures", card)
        _graph_keys_line(engine, label, card)
        print(f"[graphs] {label}: {time.perf_counter() - t_engine:.1f} s", flush=True)
        del engine
        torch.cuda.empty_cache()
    del ar_model

    t_engine = time.perf_counter()
    engine = ARNNServingEngine(arnn, batch_buckets=GRAPH_ARNN_BUCKETS, dtype="bfloat16",
                               device="cuda")
    rng = np.random.default_rng(24)
    calls, reqs = [], {}
    for b in GRAPH_ARNN_BUCKETS:
        tokens = _arnn_request(rng, b, ARNN_BARS)
        reqs[b] = tokens
        # full-length rows and rows two measures short (the tick mask)
        mixed = [r for r in (
            {"tokens": tokens[:b // 2], "start_measure": ARNN_START,
             "num_measures": ARNN_SPAN, "temperature": 1.5, "seed": 3},
            {"tokens": tokens[b // 2:, :ARNN_BARS - 2], "start_measure": 2,
             "num_measures": 3, "temperature": 0.8}) if len(r["tokens"])]
        calls += [
            (f"argmax batch {b}", lambda t=tokens: engine.inpaint(t, ARNN_START, ARNN_SPAN)),
            (f"sampled batch {b}", lambda t=tokens: engine.inpaint(
                t, ARNN_START, ARNN_SPAN, seed=3, temperature=1.5)),
            (f"inpaint_hetero sampled batch {b}, short rows",
             lambda r=mixed: engine.inpaint_hetero(r)),
        ]
    label = "arnn bf16"
    _check_routes(engine, label, calls, totals)
    big, one = reqs[ARNN_BATCH], reqs[1]
    for kind, temp in (("argmax", None), ("sampled", 1.5)):
        kw = {} if temp is None else {"seed": 3, "temperature": temp}
        big_call = lambda kw=kw: engine.inpaint(big, ARNN_START, ARNN_SPAN, **kw)  # noqa
        one_call = lambda kw=kw: engine.inpaint(one, ARNN_START, ARNN_SPAN, **kw)  # noqa
        if temp is None:  # the sampled decode is an eager loop: no hand-written kernel
            kernels = _same_kernels([(graphs, _on_route(engine, graphs, one_call))
                                     for graphs in (False, True)])
            print(f"[graphs] {label} {kind}: the profiler names the same hand-written kernels "
                  f"in one replay as in one eager call: {kernels[True] == kernels[False]} "
                  f"{kernels[True]}", flush=True)
            if kernels[True] != kernels[False] or not kernels[True]:
                raise RuntimeError(f"{label} {kind}: a replay's hand-written kernels "
                                   f"{kernels[True]} differ from the eager call's "
                                   f"{kernels[False]}")
        _graph_times(engine, f"{label} {kind}", big_call, one_call, ARNN_BATCH, ARNN_SPAN,
                     "span-measures", card)
    _graph_keys_line(engine, label, card)
    print(f"[graphs] {label}: {time.perf_counter() - t_engine:.1f} s", flush=True)
    del engine
    torch.cuda.empty_cache()
    print(f"[graphs] phase 23: {time.perf_counter() - t0:.1f} s; replays' launches {totals} | "
          f"{card}", flush=True)
    return totals


# ---------------------------------------------------------------------------
# Phase 25: every hidden width on the kernel routes (zero units), K5/K6 to 1024
# ---------------------------------------------------------------------------
NARROW_WIDTHS = (100, 200)  # K1-K4 (and K7 with C = H): 1.6 and 3.1 blocks of 64 units
NARROW_K7 = ((100, 100), (200, 200), (48, 100))  # (H, C), each padded on its own
NARROW_K8 = ((100, torch.float32), (100, torch.bfloat16), (576, torch.bfloat16),
             (704, torch.bfloat16))  # bf16 576 and 704: 9 and 11 blocks, run at 640 and 768
NARROW_TRAIN = (100, 1024)  # K5/K6: a narrow width, and the generation GRU's
# K5/K6's shapes (rows, steps): the generation GRU's calls in a sampled
# LatentRNN step (its 32 windows, one target step a call), and the engine's
# batch over the 6 target measures
NARROW_TRAIN_SHAPES = ((LATENT_WINDOWS, 1), (BATCH, 6))
NARROW_ARNN_ROWS = 64  # K7: one bucket of the ARNN engine, 384 ticks
NARROW_ENGINE_H = 100  # the engines' VAE and LatentRNN width (K8 at 128 on "pallas")
NARROW_ARNN_ENGINE = (48, 100)  # the ARNN engine's generation H and constraint C
NARROW_ENGINE_BUCKETS = (1, 8)
# K7 at the narrow widths: phase 24's bounds, seen on weights at their
# init scale (the flagship's random ones). With noise 0.1 on every weight
# (logits near 1-2) one flip of a bf16 rounding cascading over 384 ticks
# moved the logits by one bf16 ulp there, 7.8e-3, mean 2.4e-4 (NVIDIA H100
# 80GB HBM3, 700 W): the bounds are in the flagship's logit scale, so K7
# runs at it.
NARROW_ARNN_BOUNDS = ARNN_HEAD_BOUNDS


@contextlib.contextmanager
def _gate_major():
    """The planted fault of every wrapper's zero units: the 3H (4H) gate
    columns padded as a whole at the end (``kernel_common.gate_padding``;
    the padded operands are cached per layout)."""
    from inpaintnet_tpu_torch.ops import kernel_common

    real = kernel_common.gate_padding
    kernel_common.gate_padding = lambda: 1
    try:
        yield
    finally:
        kernel_common.gate_padding = real


def _card_tree(tree, dtype, gen, noise: float = 0.1):
    """A numpy init tree on the card in ``dtype``, plus noise from ``gen``
    (the weights of a model that trained a little: less flat logits)."""
    if isinstance(tree, dict):
        return {k: _card_tree(v, dtype, gen, noise) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_card_tree(v, dtype, gen, noise) for v in tree]
    t = torch.from_numpy(np.asarray(tree, np.float32)).to("cuda")
    return (t + noise * torch.randn(t.shape, generator=gen, device="cuda")).to(dtype)


def _narrow_check(kernel, label: str, call, call_hp, plain, judge, bound, card: str,
                  library=None, tag: str = "widths") -> dict:
    """One wrapper at a width that runs on zero units: ``call()`` against
    ``plain()`` (the plain version at H) by ``judge(got, want) -> (ok,
    max_abs_err, text)``, one launch counted; the same with the gate-major
    layout planted, which ``judge`` must reject; then its time beside
    ``call_hp()`` (the wrapper on operands made at the padded width: the
    kernel's time at Hp, no padding), the plain version's and
    ``library()``'s, and ``bound(got)``, the bound of the narrow function's
    work. ``call_hp`` None: a width that runs as it is (no fault, no second
    time). -> the kernels line's entry"""
    before = kernel.launches
    got = call()
    launched = kernel.launches - before
    want = plain()
    torch.cuda.synchronize()
    ok, err, text = judge(got, want)
    fault_ok, fault_text = False, "nothing padded"
    if call_hp is not None:
        with _gate_major():
            fault_ok, _, fault_text = judge(call(), want)
    print(f"[{tag}] {kernel.__name__} {label}: {text}, {launched} launch; planted gate-major "
          f"padding: {fault_text} | {card}", flush=True)
    if not ok or launched != 1 or fault_ok:
        raise RuntimeError(f"{kernel.__name__} {label}: against its plain version {text}, "
                           f"{launched} launches; the planted gate-major padding "
                           f"{'passes' if fault_ok else 'fails'}")
    ms = cuda_ms(call, 5)
    ms_hp = None if call_hp is None else cuda_ms(call_hp, 5)
    entry = {"max_abs_err": err, "ms": ms, "ms_at_padded": ms_hp,
             "plain_ms": cuda_ms(plain, 1), **bound(got),
             "library_ms": library() if library else None, "launches": 1}
    lib = entry["library_ms"]
    print(f"[time] {kernel.__name__} {label}: kernel {ms:.3f} ms"
          + ("" if ms_hp is None else f", at the padded width {ms_hp:.3f} ms "
             f"({ms / ms_hp:.3f}x)")
          + f", plain {entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}), library {'none' if lib is None else f'{lib:.3f} ms'} | "
          f"{card}", flush=True)
    return entry


def _judge_exact(got, want):
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    return same, err, f"bit-equal {same} (max_abs_err {err:.3e})"


def _narrow_encoders(card: str) -> dict:
    """K1 (f32, bf16) and K3 (bf16 masters) at ``NARROW_WIDTHS`` on random
    weights, ``BATCH`` rows of 24 tokens. -> {kernel: {case: entry}}"""
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops.gru import gru_init
    from inpaintnet_tpu_torch.ops.linear import embedding_init

    entries = {}
    for hidden in NARROW_WIDTHS:
        rng = np.random.default_rng(hidden)
        init = gru_init(rng, 10, hidden, 2, True), embedding_init(rng, VOCAB, 10)["table"]
        tokens = torch.from_numpy(rng.integers(0, VOCAB, (BATCH, 24)).astype(np.int32)).cuda()
        for name, dtype, kernel, plain in (
                ("encoder_hn", torch.float32, ek.encoder_hn, ek.encoder_hn_reference),
                ("encoder_hn", torch.bfloat16, ek.encoder_hn, ek.encoder_hn_reference),
                ("encoder_hn_int8", torch.bfloat16, ek.encoder_hn_int8,
                 ek.encoder_hn_int8_reference)):
            gen = torch.Generator(device="cuda").manual_seed(hidden)
            gru, table = (_card_tree(t, dtype, gen) for t in init)
            padded = ek.encoder_padded_operands(gru)[0]

            def judge(got, want, name=name, dtype=dtype):
                if name.endswith("int8"):
                    return _judge_exact([got], [want])
                diff = (got.float() - want.float()).abs()
                share = (got != want).float().mean().item()
                ok = diff.max().item() <= BOUNDS[dtype]["hn"] and (
                    dtype == torch.float32 or share <= ENCODER_SHARE_BF16)
                return ok, diff.max().item(), (f"h_n max_abs_err {diff.max().item():.3e}, "
                                               f"{share:.4f} of it changed")

            label = f"{'bf16 masters' if name.endswith('int8') else str(dtype)[6:]} H {hidden}"
            kind = ("int8" if name.endswith("int8") else
                    "bf16" if dtype == torch.bfloat16 else "f32")
            library = None
            if not name.endswith("int8"):
                def library(gru=gru, table=table, dtype=dtype, hidden=hidden, kernel=kernel):
                    return cudnn_gru_ms(gru, table, tokens, kernel(gru, table, tokens),
                                        f"{str(dtype)[6:]} H {hidden}", card)
            entries.setdefault(name, {})[label] = _narrow_check(
                kernel, label, lambda: kernel(gru, table, tokens),
                lambda: kernel(padded, table, tokens), lambda: plain(gru, table, tokens), judge,
                lambda got, kind=kind: bound_of(encoder_ops(BATCH, 24, hidden), kind,
                                                nbytes(gru, table, tokens, got)),
                card, library)
    return entries


def _narrow_decoders(card: str) -> dict:
    """K2 (f32, bf16) and K4 (bf16 and f32 masters) at ``NARROW_WIDTHS`` on
    random weights (V 60), ``BATCH`` rows. -> {kernel: {case: entry}}"""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops.gru import gru_init
    from inpaintnet_tpu_torch.ops.linear import embedding_init, linear_init

    entries = {}
    for hidden in NARROW_WIDTHS:
        rng = np.random.default_rng(hidden + 1)
        init = {"embedding": embedding_init(rng, VOCAB, 10), "x_0": np.zeros(10, np.float32),
                "tick_gru": gru_init(rng, 10 + hidden, hidden, 2),
                "head": linear_init(rng, hidden, VOCAB)}
        data = (rng.standard_normal((BATCH, 4, hidden)), rng.standard_normal((2, BATCH, 4, hidden)))
        for name, dtype, kernel, plain, bound in (
                ("decode_sampling", torch.float32, dk.decode_sampling,
                 dk.decode_sampling_reference, BOUNDS[torch.float32]),
                ("decode_sampling", torch.bfloat16, dk.decode_sampling,
                 dk.decode_sampling_reference, BOUNDS[torch.bfloat16]),
                ("decode_sampling_int8", torch.bfloat16, dk.decode_sampling_int8,
                 dk.decode_sampling_int8_reference, None),
                ("decode_sampling_int8", torch.float32, dk.decode_sampling_int8,
                 dk.decode_sampling_int8_reference, None)):
            dec = _card_tree(init, dtype, torch.Generator(device="cuda").manual_seed(hidden))
            tc, hi = (torch.from_numpy(a.astype(np.float32)).to("cuda", dtype) for a in data)
            padded = dk.decode_padded_operands(dec, tc, hi)

            def judge(got, want, bound=bound):
                if bound is None:
                    return _judge_exact(got, want)
                agree = dk.agreement(got, want)
                return dk.within(agree, bound), agree["logits"], f"{agree} (bounds {bound})"

            label = (f"{str(dtype)[6:]}{' masters' if name.endswith('int8') else ''} "
                     f"H {hidden}")
            kind = "int8" if name.endswith("int8") else ("bf16" if dtype == torch.bfloat16
                                                         else "f32")
            entries.setdefault(name, {})[label] = _narrow_check(
                kernel, label, lambda: kernel(dec, tc, hi), lambda: kernel(*padded),
                lambda: plain(dec, tc, hi), judge,
                lambda got, kind=kind: bound_of(
                    decode_ops(BATCH, hidden, VOCAB), kind,
                    nbytes({k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")}, tc, hi,
                           *got)), card)
    return entries


def _narrow_arnn(card: str) -> dict:
    """K7 (f32, bf16) at ``NARROW_K7`` on random init-scale weights (linear
    256, V 60),
    ``NARROW_ARNN_ROWS`` rows of 384 ticks with a forced span. -> {case:
    entry}"""
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak
    from inpaintnet_tpu_torch.ops.linear import embedding_init, linear_init
    from inpaintnet_tpu_torch.ops.lstm import lstm_stack_init

    entries, rows, ticks = {}, NARROW_ARNN_ROWS, ARNN_BARS * 24
    for hidden, ctx in NARROW_K7:
        rng = np.random.default_rng(hidden + ctx)
        init = {"note_embedding": embedding_init(rng, VOCAB + 1, 10),
                "lstm_generation": lstm_stack_init(rng, [(10 + ctx, hidden), (hidden, hidden)]),
                "linear_1": linear_init(rng, hidden, 256),
                "linear_output_notes": linear_init(rng, 256, VOCAB)}
        ctx_np = np.tanh(rng.standard_normal((rows, ticks, ctx)))
        score = torch.from_numpy(rng.integers(0, VOCAB, (rows, ticks)).astype(np.int32)).cuda()
        force = torch.ones((rows, ticks), dtype=torch.int32, device="cuda")
        force[:, ARNN_START * 24:(ARNN_START + ARNN_SPAN) * 24] = 0
        for dtype in (torch.float32, torch.bfloat16):
            params = _card_tree(init, dtype, torch.Generator(device="cuda").manual_seed(ctx),
                                noise=0.0)
            x = torch.from_numpy(ctx_np.astype(np.float32)).to("cuda", dtype)
            start = params["note_embedding"]["table"][VOCAB:VOCAB + 1].contiguous()
            args = (params, x, score, force, start)
            padded = (*ak.arnn_padded_operands(params, x), score, force, start)
            bound = NARROW_ARNN_BOUNDS[dtype]

            def judge(got, want, bound=bound):
                agree = ak.decode_agreement(got, want, force)
                return ak.within(agree, bound), agree["logits_max"], _agreement_line(agree)

            label = f"{str(dtype)[6:]} H {hidden} C {ctx}"
            entries[label] = _narrow_check(
                ak.arnn_sampled_decode, label, lambda: ak.arnn_sampled_decode(*args),
                lambda: ak.arnn_sampled_decode(*padded),
                lambda: ak.arnn_sampled_decode_reference(*args), judge,
                lambda got, dtype=dtype: bound_of(
                    arnn_ops(rows, ticks, hidden, ctx, 256, VOCAB),
                    "bf16" if dtype == torch.bfloat16 else "f32",
                    nbytes(params, x, score, force, start, *got)), card)
    return entries


def _narrow_k8(card: str) -> dict:
    """K8 at ``NARROW_K8``: the generation GRU's shape (``BATCH`` rows, 6
    steps, target masks), against its plain version within
    ``gru_kernel.BOUNDS``; cuDNN's one-direction GRU as the library call.
    -> {case: entry}"""
    from inpaintnet_tpu_torch.ops import gru_kernel as lk

    entries = {}
    for hidden, dtype in NARROW_K8:
        args = _gru_layer_inputs(hidden, BATCH, 6, hidden, dtype, "target")
        padded = (*lk.padded_operands(*args[:4]), args[4])

        def judge(got, want, dtype=dtype):
            agree = lk.agreement(got, want)
            return (lk.within(agree, lk.BOUNDS[dtype]), agree["max_abs_err"],
                    f"{agree} (bounds {lk.BOUNDS[dtype]})")

        label = f"{str(dtype)[6:]} H {hidden} (at {padded[1].shape[0]})"
        entries[label] = _narrow_check(
            lk.gru_layer_stream, label, lambda: lk.gru_layer_stream(*args),
            lambda: lk.gru_layer_stream(*padded), lambda: lk.gru_layer_reference(*args), judge,
            lambda got, dtype=dtype, hidden=hidden: bound_of(
                gru_layer_ops(BATCH, 6, hidden), "bf16" if dtype == torch.bfloat16 else "f32",
                nbytes(args[:4], args[4], got[0], got[1])), card,
            lambda args=args, dtype=dtype: cudnn_gru_layer_ms(args, dtype))
    return entries


def _narrow_train(card: str) -> dict:
    """K5 and K6 at ``NARROW_TRAIN`` x ``NARROW_TRAIN_SHAPES``, both dtypes,
    called as the trainfast Function calls them: at ``trainfast_width`` on
    zero units (``fwd_padded_operands``, dys and h_{t-1} padded), K6 on
    K5's residuals at that width, the outputs sliced back; against the
    plain versions at H (``TRAIN_BOUNDS``), K6's on K5's sliced gates; the
    gate-major fault at the narrow width (at 1024 nothing is padded).
    -> {kernel: {case: entry}}"""
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.ops.kernel_common import pad_units, unpad_units

    def judge(got, want):
        e_max, e_mean, e_abs = _train_kernel_errs(got, want)
        bound = TRAIN_BOUNDS[got[0].dtype]
        return (e_max <= bound[0] and e_mean <= bound[1], e_abs,
                f"max {e_max:.3e} mean {e_mean:.3e} (bounds {bound}), abs {e_abs:.3e}")

    entries = {}
    for hidden in NARROW_TRAIN:
        for rows, steps in NARROW_TRAIN_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                fwd, dys = _train_kernel_case(hidden + rows, rows, steps, hidden, dtype, False)
                width = gk.trainfast_width(hidden, dtype)
                padded_fwd = gk.fwd_padded_operands(*fwd)
                out_p = gk.gru_fwd_seq(*padded_fwd)
                hprev_p = torch.cat([padded_fwd[3][None], out_p[0][:-1]])
                gates_p = (pad_units(dys, hidden, width), *out_p[1:], hprev_p)
                out = tuple(unpad_units(o, hidden, width) for o in out_p)
                hprev = unpad_units(hprev_p, hidden, width)
                gates = (fwd[0], dys, *out[1:], hprev)

                def k5(fwd=fwd, hidden=hidden, width=width):
                    return tuple(unpad_units(o, hidden, width)
                                 for o in gk.gru_fwd_seq(*gk.fwd_padded_operands(*fwd)))

                def k6(fwd=fwd, gates_p=gates_p, hidden=hidden, width=width):
                    da, dhw, dh0 = gk.gru_bwd_seq(gk.fwd_padded_operands(*fwd)[0], *gates_p)
                    return (unpad_units(da, hidden, width, 3), unpad_units(dhw, hidden, width, 3),
                            unpad_units(dh0, hidden, width))

                bounds = _k5_k6_bounds(steps, rows, hidden, dtype, fwd, out, k6(), dys, hprev)
                label = (f"{str(dtype)[6:]} H {hidden}"
                         f"{'' if width == hidden else f' (at {width})'} rows {rows} steps {steps}")
                for kernel, call, call_hp, plain, bound in (
                        (gk.gru_fwd_seq, k5, lambda: gk.gru_fwd_seq(*padded_fwd),
                         lambda: gk.gru_fwd_seq_reference(*fwd), bounds[0]),
                        (gk.gru_bwd_seq, k6, lambda: gk.gru_bwd_seq(padded_fwd[0], *gates_p),
                         lambda: gk.gru_bwd_seq_reference(*gates), bounds[1])):
                    entries.setdefault(kernel.__name__, {})[label] = _narrow_check(
                        kernel, label, call, call_hp if width != hidden else None, plain, judge,
                        lambda got, bound=bound: bound, card)
    return entries


def _width_training_step(card: str) -> dict:
    """One full-width training step of the autoregressive flagship on its
    sampled branch (32 windows of 16 bars, f32): the unmasked H-1024
    generation GRU on K5/K6 (the phase's main path: counts set to 0 before
    the step, read after: K5 8 x max_target, K6 4 x max_target, no eager
    step of that width), beside the same step with that GRU forced onto the
    eager loop it took before, in turns (K5/K6, eager, eager, K5/K6) after
    a warm-up of each; each route's device launches and time of one traced
    step. -> {kernel: launches} of the K5/K6 step"""
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops import gru as gru_mod
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.train import LatentRNNTrainer
    from inpaintnet_tpu_torch.train.data import ArrayDataset

    _, vae, model = build_flagship(seed=0, device="cuda", auto_reg=True)
    mt, gen = model.max_target, model.gen_hidden_size
    rng = np.random.default_rng(25)
    windows = rng.integers(0, VOCAB, (LATENT_WINDOWS, 1, N_BARS * 24)).astype(np.int32)
    tr = LatentRNNTrainer(ArrayDataset((windows,), N_BARS), model, lr=1e-4, device="cuda", seed=1)
    batch = tr.process_batch_data((windows,))
    real = gru_mod.trainfast_supports

    def step(route):
        gru_mod.trainfast_supports = real if route == "K5/K6" else (
            lambda h: h != gen and real(h))
        try:
            loss = tr.train_step(batch, coin=False)[0].item()
        finally:
            gru_mod.trainfast_supports = real
        if not np.isfinite(loss):
            raise RuntimeError(f"the sampled step on the {route} route: loss {loss}")
        return loss

    kernels = (gk.gru_fwd_seq, gk.gru_bwd_seq)
    counts = {}
    for route in ("K5/K6", "eager"):
        for k in kernels:
            k.launches = 0
        _, eager = _eager_gru_steps(lambda: step(route), gen)
        counts[route] = {**{k.__name__: k.launches for k in kernels}, "eager_steps": eager}
    want = {"K5/K6": {"gru_fwd_seq": 8 * mt, "gru_bwd_seq": 4 * mt, "eager_steps": 0},
            "eager": {"gru_fwd_seq": 4 * mt, "gru_bwd_seq": 0, "eager_steps": 4 * mt}}
    if counts != want:
        raise RuntimeError(f"the sampled step's launches {counts}, expected {want}")
    walls = {"K5/K6": [], "eager": []}
    for route in ("K5/K6", "eager", "eager", "K5/K6"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(route)
        walls[route].append((time.perf_counter() - t0) * 1e3)
    for route in walls:
        device_ms, launches, rows = _profile_step(lambda route=route: step(route))
        wall = float(np.mean(walls[route]))
        print(f"[widths] training step (autoregressive flagship, sampled branch, f32) on the "
              f"{route} route for the H-{gen} generation GRU: {wall:.1f} ms a step (walls "
              f"{[round(w, 1) for w in walls[route]]}), wrapper launches "
              f"{counts[route]}, {launches} device launches, device {device_ms:.1f} ms, idle "
              f"share {1 - device_ms / wall:.3f} | {card}", flush=True)
        for name, k_ms, k_count in rows[:6]:
            print(f"[profile]   {k_ms:9.3f} ms {k_count:6d}x  {name[:110]}", flush=True)
    del tr, vae, model
    torch.cuda.empty_cache()
    return counts["K5/K6"]


def _narrow_engines(card: str) -> dict:
    """The entry points a user calls, at widths that run on zero units: the
    model (VAE and LatentRNN of H ``NARROW_ENGINE_H``: ``Encoder.apply``,
    the decoder's decode, the LatentRNN's GRUs, on ``"xla"`` and on
    ``"pallas"``) and the ARNN's ``apply_inpaint`` at ``NARROW_ARNN_ENGINE``
    on the card against the CPU (phases 5 and 12's checks and bounds); then
    the serving engines at those widths, each call on the eager route and
    on the graph route (capture, replay), tokens and launches equal: the
    LatentRNN engine in bf16, int8, and bf16 and f32 on ``"pallas"``, the
    ARNN engine in f32 and bf16. -> {kernel: launches} of the graph
    route's replays (``_check_routes`` counts each call from 0; each
    kernel must launch)"""
    from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
    from inpaintnet_tpu_torch.models.presets import ARNNDataset, build_flagship
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops import gru_kernel as lk
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.serve import InpaintingEngine
    from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

    t0 = time.perf_counter()
    hidden, (gen, ctx) = NARROW_ENGINE_H, NARROW_ARNN_ENGINE
    _, _, model = build_flagship(hidden=hidden, seed=0, device="cuda")
    for impl in ("xla", "pallas"):
        print(f"[widths] the model's entry points at H {hidden} on {impl!r}, card against CPU:",
              flush=True)
        with gru_impl_scope(impl):
            phase_reference(model, quantized=False)
    phase_arnn_reference(hidden=gen, ctx=ctx)
    arnn = AnticipationRNNBaseline(
        ARNNDataset(), note_embedding_dim=10, metadata_embedding_dim=2,
        num_lstm_constraints_units=ctx, num_lstm_generation_units=gen, linear_hidden_size=256,
        num_layers=2, unary_constraint=True, device="cuda", seed=0)
    buckets, totals = NARROW_ENGINE_BUCKETS, {}

    def serve():
        for label, dtype, impl in (("bf16", "bfloat16", "xla"), ("int8", "int8", "xla"),
                                   ("bf16 pallas", "bfloat16", "pallas"),
                                   ("f32 pallas", "float32", "pallas")):
            engine = InpaintingEngine(model, batch_buckets=buckets, dtype=dtype, device="cuda")
            with gru_impl_scope(impl):
                calls = _latent_graph_calls(engine, np.random.default_rng(25), buckets)[0]
                _check_routes(engine, f"H {hidden} {label}", calls, totals)
        for dtype in ("float32", "bfloat16"):
            engine = ARNNServingEngine(arnn, batch_buckets=buckets, dtype=dtype, device="cuda")
            rng = np.random.default_rng(26)
            calls = []
            for b in buckets:
                tokens = _arnn_request(rng, b, ARNN_BARS)
                calls += [(f"argmax batch {b}", lambda t=tokens, e=engine: e.inpaint(
                               t, ARNN_START, ARNN_SPAN)),
                          (f"sampled batch {b}", lambda t=tokens, e=engine: e.inpaint(
                              t, ARNN_START, ARNN_SPAN, seed=3, temperature=1.5))]
            _check_routes(engine, f"arnn {dtype} H {gen} C {ctx}", calls, totals)

    serve()
    launches = {k.__name__: totals.get(k.__name__, 0)
                for k in (ek.encoder_hn, dk.decode_sampling, ek.encoder_hn_int8,
                          dk.decode_sampling_int8, lk.gru_layer_stream, ak.arnn_sampled_decode)}
    if min(launches.values()) < 1:
        raise RuntimeError(f"the engines at narrow widths did not launch every kernel: "
                           f"{launches}")
    print(f"[widths] engines at H {hidden} and ARNN H {gen} C {ctx}: the graph route's "
          f"replays launched {totals}; {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    del model, arnn
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 26: K1-K4 above 512 units in bf16 masters (K1/K3 to H 577, K2/K4 to
# H 717: the JAX kernels' VMEM gates)
# ---------------------------------------------------------------------------
WIDE_ENCODER = (576, 577)  # K1 at 576 on 2 consumer warpgroups; 577 at 640 on zero units
WIDE_K3 = 527  # K3: the widest H the JAX package quantizes in bf16, run at 576
WIDE_ENCODER_ROWS = (BATCH, 65536)  # the engine's batch, and the encoder's serving shape
WIDE_DECODE = (576, 640, 704, 717)  # K2/K4 at 576 (3 CTAs), 640, and 768 (half-slab boxes)
WIDE_DECODE_ROWS = (BATCH, BATCH * 6)
WIDE_VOCABS = (VOCAB, 128)
WIDE_ENGINE = (577, 640)  # the engines' VAE: encoder H (K1/K3 at 640), decoder H
WIDE_ENTRY = (576, 704)  # the entry points' encoder and decoder H
WIDE_ENTRY_ROWS = 256  # the entry points' rows (the CPU runs the plain versions)
# The entry points on the card against the CPU: h_n within BOUNDS' h_n and
# K1's share; the decode's tokens equal on phase 5's share (0.99: the two
# devices' plain versions and kernels round apart, and the initialisation's
# near-flat logits turn that into other argmax tokens; seen 0.9924 at these
# widths, NVIDIA H100 80GB HBM3, 700 W), its logits within BOUNDS where both
# fed back the same tokens (seen 2.4e-4)
WIDE_ENTRY_BOUNDS = {"tokens": 0.99, "logits": BOUNDS[torch.bfloat16]["logits"]}
# K2/K4's weights: the layers' initialisation plus noise 0.03, logits
# inside BOUNDS' "two ulps of logits up to 4" at these widths (noise 0.05
# took H 576's past 4, where one ulp is 0.03125; noise 0.1 past 8; NVIDIA
# H100 80GB HBM3, 700 W), and far enough from flat that the planted
# gate-major padding shows. K1/K3 run at the initialisation's scale, as
# phase 3 holds K1 at 65,536 rows.
WIDE_DECODE_NOISE = 0.03


def _wide_model(enc_hidden: int, dec_hidden: int, vocab: int = VOCAB, seed: int = 0):
    """A LatentRNN (2 x 64) over a MeasureVAE whose encoder is
    ``enc_hidden`` and whose decoder is ``dec_hidden`` units wide, seeded
    random weights on the card in f32 (``presets.build_flagship``'s
    construction, two widths)."""
    from inpaintnet_tpu_torch.models.convert import from_jax_params
    from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
    from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
    from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset

    vae = MeasureVAE(VocabOnlyDataset(vocab), note_embedding_dim=10, num_encoder_layers=2,
                     encoder_hidden_size=enc_hidden, latent_space_dim=256, num_decoder_layers=2,
                     decoder_hidden_size=dec_hidden, device="meta")
    model = LatentRNN(vae, num_rnn_layers=2, rnn_hidden_size=64, device="meta")
    rng = np.random.default_rng(seed)
    vae_np = vae.init_params(rng)
    model.to_empty(device="cuda")
    model.load_state_dict(from_jax_params(vae_np, model.init_params(rng)), strict=True)
    return model


def _encoder_judge(name: str):
    def judge(got, want):
        if name.endswith("int8"):
            return _judge_exact([got], [want])
        diff = (got.float() - want.float()).abs()
        share = (got != want).float().mean().item()
        ok = diff.max().item() <= BOUNDS[torch.bfloat16]["hn"] and share <= ENCODER_SHARE_BF16
        return ok, diff.max().item(), (f"h_n max_abs_err {diff.max().item():.3e}, {share:.4f} "
                                       f"of it changed (bounds {BOUNDS[torch.bfloat16]['hn']}, "
                                       f"{ENCODER_SHARE_BF16})")
    return judge


def _wide_encoders(card: str) -> dict:
    """K1 bf16 at ``WIDE_ENCODER`` and K3 (bf16 masters) at ``WIDE_K3``, x
    ``WIDE_ENCODER_ROWS``, and K1's training mode at 576, on the layers'
    initialisation, 24 tokens a row, each against its plain version, the
    planted gate-major padding rejected where the width runs on zero units,
    timed beside cuDNN's ``nn.GRU(10, H, 2, bidirectional=True)``. ->
    {kernel: {case: entry}}"""
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.ops.gru import gru_init
    from inpaintnet_tpu_torch.ops.linear import embedding_init

    entries = {}
    for hidden in (*WIDE_ENCODER, WIDE_K3):
        rng = np.random.default_rng(hidden)
        init = gru_init(rng, 10, hidden, 2, True), embedding_init(rng, VOCAB, 10)["table"]
        gen = torch.Generator(device="cuda").manual_seed(hidden)
        gru, table = (_card_tree(t, torch.bfloat16, gen, 0.0) for t in init)
        padded = ek.encoder_padded_operands(gru)[0]
        on_zero_units = padded[0][0]["w_hh"].shape[0] != hidden
        for rows in WIDE_ENCODER_ROWS:
            tokens = torch.from_numpy(rng.integers(0, VOCAB, (rows, 24)).astype(np.int32)).cuda()
            cases = ([("encoder_hn_int8", ek.encoder_hn_int8, ek.encoder_hn_int8_reference,
                       "int8", None)] if hidden == WIDE_K3 else
                     [("encoder_hn", ek.encoder_hn, ek.encoder_hn_reference, "bf16", None)])
            if hidden == 576 and rows == BATCH:  # the training mode, rate 0.5 (the VAE's)
                keep = torch.rand((rows, 24, 2 * hidden), generator=gen, device="cuda") >= 0.5
                cases.append(("encoder_hn", ek.encoder_hn, ek.encoder_hn_reference, "bf16",
                              keep))
            for name, kernel, plain, kind, keep in cases:
                label = (f"{'bf16 masters' if kind == 'int8' else 'bf16'} H {hidden} rows {rows}"
                         + (" training mode" if keep is not None else ""))
                extra = {} if keep is None else {"keep": keep, "rate": 0.5}
                plain_extra = () if keep is None else (keep, 0.5)
                library = None
                if kind == "bf16" and keep is None:
                    def library(tokens=tokens, hidden=hidden, rows=rows):
                        h_n = ek.encoder_hn(gru, table, tokens)
                        # cuDNN's GRU at H 577 x 65,536 rows asks for 22.3 GiB
                        # at once: hand it the blocks this case left cached
                        torch.cuda.empty_cache()
                        return cudnn_gru_ms(gru, table, tokens, h_n,
                                            f"bf16 H {hidden} rows {rows}", card)
                # K3's wrapper takes only widths the JAX package quantizes:
                # its time at the padded width is its launch's
                at_width = ek._encoder_int8_launch if kind == "int8" else (
                    lambda *a, k=kernel: k(*a[:3]))
                entries.setdefault(name, {})[label] = _narrow_check(
                    kernel, label, lambda k=kernel, t=tokens, e=extra: k(gru, table, t, **e),
                    (lambda t=tokens: at_width(padded, table, t, None))
                    if on_zero_units and keep is None else None,
                    lambda p=plain, t=tokens, e=plain_extra: p(gru, table, t, *e),
                    _encoder_judge(name),
                    lambda got, kind=kind, t=tokens, rows=rows, e=plain_extra: bound_of(
                        encoder_ops(rows, 24, hidden), kind, nbytes(gru, table, t, got, *e[:1])),
                    card, library, tag="wide")
    return entries


def _wide_decoders(card: str) -> dict:
    """K2 bf16 and K4 (bf16 masters) at ``WIDE_DECODE`` x
    ``WIDE_DECODE_ROWS`` x ``WIDE_VOCABS`` (noise ``WIDE_DECODE_NOISE``),
    each against its plain version (K2 within BOUNDS, K4 bit-equal), the
    planted gate-major padding rejected where the width runs on zero units.
    -> {kernel: {case: entry}}"""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops.gru import gru_init
    from inpaintnet_tpu_torch.ops.linear import embedding_init, linear_init

    entries = {}
    for hidden in WIDE_DECODE:
        for vocab in WIDE_VOCABS:
            rng = np.random.default_rng(hidden + vocab)
            init = {"embedding": embedding_init(rng, vocab, 10), "x_0": np.zeros(10, np.float32),
                    "tick_gru": gru_init(rng, 10 + hidden, hidden, 2),
                    "head": linear_init(rng, hidden, vocab)}
            dec = _card_tree(init, torch.bfloat16,
                             torch.Generator(device="cuda").manual_seed(hidden + vocab),
                             WIDE_DECODE_NOISE)
            for rows in WIDE_DECODE_ROWS:
                data = (rng.standard_normal((rows, 4, hidden)),
                        rng.standard_normal((2, rows, 4, hidden)))
                tc, hi = (torch.from_numpy(a.astype(np.float32)).to("cuda", torch.bfloat16)
                          for a in data)
                padded = dk.decode_padded_operands(dec, tc, hi)
                for name, kernel, plain, kind in (
                        ("decode_sampling", dk.decode_sampling, dk.decode_sampling_reference,
                         "bf16"),
                        ("decode_sampling_int8", dk.decode_sampling_int8,
                         dk.decode_sampling_int8_reference, "int8")):
                    def judge(got, want, kind=kind):
                        if kind == "int8":
                            return _judge_exact(got, want)
                        agree = dk.agreement(got, want)
                        bound = BOUNDS[torch.bfloat16]
                        return dk.within(agree, bound), agree["logits"], f"{agree} (bounds {bound})"

                    label = (f"{'bf16 masters' if kind == 'int8' else 'bf16'} H {hidden} "
                             f"(at {padded[1].shape[2]}) V {vocab} rows {rows}")
                    entries.setdefault(name, {})[label] = _narrow_check(
                        kernel, label, lambda k=kernel: k(dec, tc, hi),
                        None if padded[1] is tc else lambda k=kernel: k(*padded),
                        lambda p=plain: p(dec, tc, hi), judge,
                        lambda got, kind=kind, rows=rows, vocab=vocab: bound_of(
                            decode_ops(rows, hidden, vocab), kind,
                            nbytes({k: dec[k] for k in ("embedding", "x_0", "tick_gru", "head")},
                                   tc, hi, *got)), card, tag="wide")
    return entries


def _wide_entry_points(card: str) -> None:
    """The entry points a user calls, bf16 masters, encoder H 576 and
    decoder H 704 (at 768): ``Encoder.apply`` on the card (K1) against the
    CPU (K1's plain version), h_n within BOUNDS' h_n and share; the
    decoder's ``decode_sampling`` of the CPU's z on the card (K2) against
    the CPU within ``WIDE_ENTRY_BOUNDS``; one launch each."""
    from inpaintnet_tpu_torch.models.base import cast_params
    from inpaintnet_tpu_torch.models import measure_vae as mv
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek

    vae = _wide_model(*WIDE_ENTRY).vae_model
    tokens = np.random.default_rng(7).integers(0, VOCAB, (WIDE_ENTRY_ROWS, 24)).astype(np.int32)
    h_n, outs, z = {}, {}, None
    real = mv.encoder_hn
    try:
        for dev in ("cpu", "cuda"):  # the card decodes the CPU's z
            params = cast_params(vae.params(), dev, torch.bfloat16)
            mv.encoder_hn = lambda *a, dev=dev: h_n.setdefault(dev, real(*a))
            with torch.inference_mode():
                before = (ek.encoder_hn.launches, dk.decode_sampling.launches)
                dist = vae.encoder.apply(params["encoder"], torch.from_numpy(tokens).to(dev))
                z = dist.loc if z is None else z.to(dev)
                outs[dev] = vae.decoder.decode_sampling(params["decoder"], z)
                launched = (ek.encoder_hn.launches - before[0],
                            dk.decode_sampling.launches - before[1])
            if launched != ((1, 1) if dev == "cuda" else (0, 0)):
                raise RuntimeError(f"the entry points on {dev} launched {launched}")
    finally:
        mv.encoder_hn = real
    ok, err, text = _encoder_judge("encoder_hn")(h_n["cuda"].cpu(), h_n["cpu"])
    agree = dk.agreement(tuple(t.cpu() for t in outs["cuda"]), outs["cpu"])
    print(f"[wide] entry points, encoder H {WIDE_ENTRY[0]} and decoder H {WIDE_ENTRY[1]}, card "
          f"against CPU: Encoder.apply {text}; decode_sampling {agree} (bounds "
          f"{WIDE_ENTRY_BOUNDS}) | {card}", flush=True)
    if not (ok and dk.within(agree, WIDE_ENTRY_BOUNDS)):
        raise RuntimeError("the wide entry points on the card disagree with the CPU")


def _wide_engines(card: str) -> dict:
    """``InpaintingEngine`` over a VAE of ``WIDE_ENGINE`` (K1 at 640 on zero
    units, K2/K4 at 640 on 2 CTAs a tile) in bf16 and int8, each call on
    the eager route and on the graph route (capture, replay), tokens and
    launches equal. int8 quantizes only where the JAX package does: its
    encoder gate is closed at 577 in bf16 (18 H^2 x 2 bytes: 11.99e6), so
    the int8 engine runs K1 and K4 and never K3. -> {kernel: launches} of
    the graph route's replays (K3's 0)"""
    from inpaintnet_tpu_torch.ops import decode_kernel as dk
    from inpaintnet_tpu_torch.ops import encoder_kernel as ek
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    t0 = time.perf_counter()
    model, buckets, totals = _wide_model(*WIDE_ENGINE), NARROW_ENGINE_BUCKETS, {}
    kernels = (ek.encoder_hn, dk.decode_sampling, ek.encoder_hn_int8, dk.decode_sampling_int8)
    want = {"bfloat16": (True, True, False, False), "int8": (True, False, False, True)}
    for dtype in ("bfloat16", "int8"):
        engine = InpaintingEngine(model, batch_buckets=buckets, dtype=dtype, device="cuda")
        calls = _latent_graph_calls(engine, np.random.default_rng(26), buckets)[0]
        own = {}
        _check_routes(engine, f"VAE encoder H {WIDE_ENGINE[0]} decoder H {WIDE_ENGINE[1]} "
                      f"{dtype}", calls, own)
        if tuple(own.get(k.__name__, 0) > 0 for k in kernels) != want[dtype]:
            raise RuntimeError(f"the wide {dtype} engine launched {own}: K1, K2, K3, K4 "
                               f"expected {want[dtype]}")
        for k, n in own.items():
            totals[k] = totals.get(k, 0) + n
        del engine
    launches = {k.__name__: totals.get(k.__name__, 0) for k in kernels}
    print(f"[wide] engines over the VAE of H {WIDE_ENGINE}: the graph route's replays launched "
          f"{totals}; {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 27: K7 at every geometry the JAX package's kernel gate takes (a
# context C above 512 in both dtypes, bf16 H from 513 to 640 on half-slab
# boxes and clusters of 9 and 10 CTAs), and K8 under a gradient
# ---------------------------------------------------------------------------
# (H, C, dtype): JAX's widest bf16 H at C 256, 64 and 16 (582, 612, 619: run
# at 576 on 9 CTAs and 640 on 10), bf16 C 1,024 and 3,954 (the widest at H
# 256) at H 256, and f32's widest C at H 256, 1,513; each at 512 rows and
# at 1 row
ARNN_WIDTHS = ((576, 256, torch.bfloat16), (600, 64, torch.bfloat16),
               (619, 16, torch.bfloat16), (256, 1024, torch.bfloat16),
               (256, 3954, torch.bfloat16), (256, 1513, torch.float32))
ARNN_WIDTHS_VOCABS = (VOCAB, 90)
ARNN_WIDTHS_ENGINE = (576, 256)  # the bf16 ARNN engine's generation H and constraint C
# K7 at these geometries against its plain version: ARNN_BOUNDS (V 90:
# ARNN_HEAD_BOUNDS). Its early-logit share grew with the sums' lengths
# while the tensor cores summed a whole product in one accumulator (0.28 at
# C 3,954, `--k7-sums`); in partials of four k-slabs added in rounded f32
# it stays within ARNN_BOUNDS' (PERF.md).


def _arnn_width_case(hidden: int, ctx: int, dtype, vocab: int, rows: int):
    """K7's inputs at (H, C), linear 256 (the flagship's), ``rows`` x 384
    ticks with the middle third unforced: the layers' initialisation
    (``_arnn_case``'s), the context and tokens drawn on the card (numpy
    takes ~15 s for a C-3,954 context)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda_kernels import _arnn_case

    ticks = ARNN_BARS * 24
    params, _, _, _, start = _arnn_case(np.random.default_rng(hidden + ctx + vocab), 1, hidden,
                                        ctx, 1, vocab, 256, dtype, "cuda", noise=0.0)
    gen = torch.Generator(device="cuda").manual_seed(hidden + ctx + vocab)
    x = torch.tanh(torch.randn((rows, ticks, ctx), generator=gen, device="cuda")).to(dtype)
    score = torch.randint(0, vocab, (rows, ticks), generator=gen, device="cuda",
                          dtype=torch.int32)
    force = torch.ones((rows, ticks), dtype=torch.int32, device="cuda")
    force[:, ticks // 3: 2 * ticks // 3] = 0
    return params, x, score, force, start


def _arnn_width_faults(ak, args, got, bound, label: str) -> None:
    """The planted faults at a new width, each against the kernel's output
    by the same bound: a c carry kept in f32 (bf16), the context projection
    rounded to bf16 (the staged plain version); both must break it."""
    force = args[3]
    carry, projection = ak.carry_c, ak.ctx_projection
    faults = {}
    ak.carry_c = lambda c, dtype: c
    try:
        faults["c carry kept in f32"] = ak.arnn_sampled_decode_reference(*args)
    finally:
        ak.carry_c = carry
    ak.ctx_projection = lambda ctx, w: projection(ctx, w).to(torch.bfloat16).float()
    try:
        faults["context projection rounded to bf16"] = \
            ak.arnn_sampled_decode_staged_reference(*args)
    finally:
        ak.ctx_projection = projection
    for name, planted in faults.items():
        agree = ak.decode_agreement(got, planted, force)
        print(f"[arnn-widths] planted fault {label}, {name}: {_agreement_line(agree)}",
              flush=True)
        if ak.within(agree, bound):
            raise RuntimeError(f"a planted K7 fault passes at {label}: {name}")


def _arnn_widths_kernel(card: str) -> dict:
    """K7 at ``ARNN_WIDTHS`` x ``ARNN_WIDTHS_VOCABS`` at 512 rows against
    its plain version, one wrapper launch each and, at V 60, two CUDA
    launches in a trace; at 1 row (the 512-row inputs' first) bit-equal to
    the 512-row call's first row and within the logits' bounds (a lone
    row's token and early shares are all or nothing: one flip cascades over
    its row, seen 0.9896 of one row's tokens); the planted faults at the widest
    bf16 H and C; a tie across a head chunk at H 576 and its planted fault;
    each 512-row case timed beside its bound and the plain version. ->
    {case: entry}"""
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    entries, ticks, rows = {}, ARNN_BARS * 24, ARNN_BATCH
    for hidden, ctx, dtype in ARNN_WIDTHS:
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for vocab in ARNN_WIDTHS_VOCABS:
            base = ARNN_BOUNDS[dtype] if vocab == VOCAB else ARNN_HEAD_BOUNDS[dtype]
            label = f"{tag} H {hidden} C {ctx} V {vocab}"
            args = _arnn_width_case(hidden, ctx, dtype, vocab, rows)
            bound = base
            before = ak.arnn_sampled_decode.launches
            got = ak.arnn_sampled_decode(*args)
            one_args = tuple(a[:1] if i in (1, 2, 3) else a for i, a in enumerate(args))
            one = ak.arnn_sampled_decode(*one_args)
            launched = ak.arnn_sampled_decode.launches - before
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            want = ak.arnn_sampled_decode_reference(*args)
            end.record()
            torch.cuda.synchronize()
            agree = ak.decode_agreement(got, want, args[3])
            agree_one = ak.decode_agreement(one, tuple(t[:1] for t in want), args[3][:1])
            same_one = all(torch.equal(a, b[:1]) for a, b in zip(one, got))
            expect = ak.arnn_cuda_launches(dtype, rows, ticks, hidden, 256, vocab)
            traced = {}
            if vocab == VOCAB:
                traced = _own_kernels(lambda: ak.arnn_sampled_decode(*args), want=expect)
            recurrence = "arnn_kernel" if dtype == torch.bfloat16 else "arnn_f32_kernel"
            print(f"[arnn-widths] arnn_sampled_decode {label} rows {rows}: "
                  f"{_agreement_line(agree)} (bounds {bound}); CUDA launches "
                  f"{traced or 'not traced'}; 1 row: bit-equal to row 0 {same_one}, "
                  f"{_agreement_line(agree_one)} | {card}", flush=True)
            faults = [why for why, bad in (
                ("not one wrapper launch a call", launched != 2),
                ("outside its bounds", not ak.within(agree, bound)),
                ("1 row: not row 0 of the batch", not same_one),
                ("1 row: outside its bounds", not ak.within(agree_one, {**bound, "tokens": 0.0,
                                                                         "early": 1.0})),
                ("not finite", not bool(torch.isfinite(got[0].float()).all())),
                (f"traced CUDA launches {traced}, {expect} expected",
                 bool(traced) and (sum(traced.values()) != expect
                                   or traced.get(recurrence, 0) != expect // 2))) if bad]
            if faults:
                raise RuntimeError(f"K7 {label}: " + "; ".join(faults))
            if vocab == VOCAB and (hidden, ctx) in ((619, 16), (256, 3954)):
                _arnn_width_faults(ak, args, got, bound, label)
            ms = cuda_ms(lambda: ak.arnn_sampled_decode(*args), 3)
            ops = arnn_ops(rows, ticks, hidden, ctx, 256, vocab)
            moved = nbytes({k: args[0][k] for k in ("note_embedding", "lstm_generation",
                                                    "linear_1", "linear_output_notes")},
                           *args[1:], *got)
            b = bound_of(ops if dtype == torch.bfloat16 else 6 * ops, "bf16", moved)
            plan = (ak.arnn_card_plan if dtype == torch.bfloat16 else ak.arnn_f32_card_plan)(
                rows, ak.arnn_width(hidden, dtype), 256, args[1].device)
            entries[label] = {"max_abs_err": agree["logits_max"], "ms": ms,
                              "plain_ms": start.elapsed_time(end), **b, "library_ms": None,
                              "launches": launched, "cluster": plan.cluster}
            print(f"[time] arnn_sampled_decode {label} rows {rows}: kernel {ms:.3f} ms (run at "
                  f"H {ak.arnn_width(hidden, dtype)}, C {ak.arnn_ctx_width(ctx)}; cluster "
                  f"{plan.cluster}, stages {plan.stages}), plain "
                  f"{entries[label]['plain_ms']:.3f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}) | {card}", flush=True)
    # the first index across the first output chunk border at H 576, and the
    # planted fault (a later chunk wins ties)
    params, ctx, score, force, _ = _arnn_width_case(576, 256, torch.bfloat16, 130, 64)
    params = _tied(params, "linear_output_notes", ak.ARNN_OUT_COLS)
    args = (params, ctx, score, force, params["note_embedding"]["table"][130:].contiguous())
    want = ak.arnn_sampled_decode_reference(*args)[1]
    got = ak.arnn_sampled_decode(*args)[1]
    with _later_chunk_wins_ties():
        fault = ak.arnn_sampled_decode(*args)[1]
    torch.cuda.synchronize()
    free = force == 0
    print(f"[arnn-widths] bf16 H 576 tie across the chunk border: plain sampled tokens all 5 "
          f"{bool((want[free] == 5).all())}, kernel equal {bool(torch.equal(got, want))}; "
          f"planted fault (the later chunk wins ties) equal {bool(torch.equal(fault, want))}",
          flush=True)
    if not ((want[free] == 5).all() and torch.equal(got, want)) or torch.equal(fault, want):
        raise RuntimeError("K7 at H 576: the chunk-border tie is not taken by the first index, "
                           "or its planted fault passes")
    return entries


def _arnn_widths_engine(card: str) -> dict:
    """The bf16 ``ARNNServingEngine`` over an ARNN of generation H 576 and
    constraint C 256 (``ARNN_WIDTHS_ENGINE``; linear 256, the flagship's
    other widths), buckets 1 and 8, argmax and sampled calls, each on the
    eager route and on the graph route (capture, replay), tokens and
    launches equal. -> {kernel: launches} of the replays (K7 must launch)"""
    from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
    from inpaintnet_tpu_torch.models.presets import ARNNDataset
    from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

    t0 = time.perf_counter()
    gen, ctx = ARNN_WIDTHS_ENGINE
    arnn = AnticipationRNNBaseline(
        ARNNDataset(), note_embedding_dim=10, metadata_embedding_dim=2,
        num_lstm_constraints_units=ctx, num_lstm_generation_units=gen, linear_hidden_size=256,
        num_layers=2, unary_constraint=True, device="cuda", seed=0)
    engine = ARNNServingEngine(arnn, batch_buckets=NARROW_ENGINE_BUCKETS, dtype="bfloat16",
                               device="cuda")
    rng, calls, totals = np.random.default_rng(27), [], {}
    for b in NARROW_ENGINE_BUCKETS:
        tokens = _arnn_request(rng, b, ARNN_BARS)
        calls += [(f"argmax batch {b}", lambda t=tokens: engine.inpaint(t, ARNN_START,
                                                                        ARNN_SPAN)),
                  (f"sampled batch {b}", lambda t=tokens: engine.inpaint(
                      t, ARNN_START, ARNN_SPAN, seed=3, temperature=1.5))]
    _check_routes(engine, f"arnn bf16 H {gen} C {ctx}", calls, totals)
    if totals.get("arnn_sampled_decode", 0) < 1:
        raise RuntimeError(f"the ARNN engine at H {gen} C {ctx} did not launch K7: {totals}")
    print(f"[arnn-widths] engine at H {gen} C {ctx}: the graph route's replays launched "
          f"{totals}; {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    del engine, arnn
    torch.cuda.empty_cache()
    return totals


def _k8_gradient(card: str) -> dict:
    """A gradient through K8: one GRU layer of H 512 (f32, the context GRU's
    shape: 2,048 rows x 16 steps, masked) on ``"pallas"`` fed by an
    upstream projection, a loss linear in its outputs: K8 launches once,
    and every weight's gradient, the upstream one's included, equals the
    ``"xla"`` route's bit for bit. -> {"launches": K8's}"""
    from inpaintnet_tpu_torch.ops import gru as gru_mod
    from inpaintnet_tpu_torch.ops import gru_kernel as lk
    from inpaintnet_tpu_torch.ops.gru import gru_init

    rng = np.random.default_rng(27)
    layer = {k: torch.from_numpy(np.asarray(v, np.float32)).cuda()
             for k, v in gru_init(rng, 256, 512, 1)[0][0].items()}
    up = torch.from_numpy((rng.standard_normal((64, 256)) / 8).astype(np.float32)).cuda()
    inp = torch.from_numpy(rng.standard_normal((BATCH, N_BARS, 64)).astype(np.float32)).cuda()
    mask = (torch.arange(N_BARS, device="cuda")[None] < torch.from_numpy(
        rng.integers(0, N_BARS + 1, BATCH)).cuda()[:, None]).float()
    wy = torch.from_numpy(rng.standard_normal((BATCH, N_BARS, 512)).astype(np.float32)).cuda()

    def grads(impl):
        leaves = {**{k: v.clone().requires_grad_() for k, v in layer.items()},
                  "w_up": up.clone().requires_grad_()}
        ys, h_last = gru_mod.gru_layer_apply({k: leaves[k] for k in layer},
                                             torch.tanh(inp @ leaves["w_up"]),
                                             torch.zeros((BATCH, 512), device="cuda"),
                                             mask=mask, impl=impl)
        ((ys * wy).sum() + h_last.sum()).backward()
        return {k: v.grad for k, v in leaves.items()}

    before = lk.gru_layer_stream.launches
    got = grads("pallas")
    launched = lk.gru_layer_stream.launches - before
    want = grads("xla")
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(got[k], want[k])) for k in got}
    print(f"[arnn-widths] gradient through K8 (f32 H 512, {BATCH} rows x {N_BARS} steps, "
          f"masked): {launched} K8 launch; equal to the eager route's {same}; upstream "
          f"|grad| max {got['w_up'].abs().max().item():.3e} | {card}", flush=True)
    if launched != 1 or not all(same.values()) or not got["w_up"].abs().max() > 0:
        raise RuntimeError("the gradient through K8 is not the eager route's")
    return {"launches": launched}


def phase_arnn_widths(card: str) -> tuple:
    """Phase 27: K7 at every geometry the JAX kernel's gate takes, its ARNN
    engine at H 576, and a gradient through K8. -> ({case: entry} of K7,
    {kernel: launches} of the engine's replays, K8's gradient entry)"""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    entries = _arnn_widths_kernel(card)
    launches = _arnn_widths_engine(card)
    gradient = _k8_gradient(card)
    torch.cuda.empty_cache()
    print(f"[arnn-widths] phase 27 took {time.perf_counter() - t0:.1f} s", flush=True)
    return entries, launches, gradient


# K7's bf16 sums, taken apart (``--k7-sums``): at these (H, C), 512 rows x
# 384 ticks, V 60, the kernel at each context GEMM group
# (``arnn_kernel.ARNN_CTX_GROUP``; 0: the whole of K in one accumulator)
# against the plain version, and against the hybrid that feeds that GEMM's
# own output into the plain recurrence; the GEMM's error against a float64
# product beside cuBLAS f32's
K7_SUMS_CASES = ((256, 256), (256, 1024), (256, 3954), (512, 512), (576, 256), (640, 16))
K7_SUMS_GROUPS = (0, 1, 2, 4)
K7_SUMS_ROWS = 16  # rows of the GEMMs' float64 comparison (x 384 ticks)


def _k7_ctx_gemm(ctx: torch.Tensor, w_ctx: torch.Tensor, group: int):
    """(a call of the bf16 route's context GEMM, its (B, T, 4H) f32 out) on
    ``ctx`` (B, T, C) and ``w_ctx`` (C, 4H) bf16, C zero-padded to whole
    64-column slabs as the wrapper pads it."""
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak
    from inpaintnet_tpu_torch.ops.kernel_common import check_launch, load_kernels, stream_ptr

    batch, ticks, width = ctx.shape
    depth = ak.arnn_ctx_width(width)
    a = torch.nn.functional.pad(ctx, (0, depth - width)).reshape(batch * ticks, depth)
    w = torch.nn.functional.pad(w_ctx.t(), (0, depth - width)).contiguous()
    out = torch.empty((batch * ticks, w.shape[0]), dtype=torch.float32, device=ctx.device)
    lib = load_kernels()

    def call():
        check_launch(lib.inpaint_arnn_ctx_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                                               batch * ticks, depth, w.shape[0], group,
                                               stream_ptr()), "K7's context GEMM")
    call()
    return call, out.reshape(batch, ticks, -1)


def _gemm_error(got: torch.Tensor, exact: torch.Tensor) -> str:
    """A GEMM's f32 output against the float64 product: max and mean |err|,
    the mean error toward zero (err x sign(exact): negative where the sums
    lose magnitude), RMS error over RMS value, and the share of outputs not
    equal to the float64 product rounded to f32."""
    err = got.double() - exact
    return (f"max {err.abs().max().item():.3e}, mean {err.abs().mean().item():.3e}, signed "
            f"(x sign) {(err * exact.sign()).mean().item():+.3e}, rel rms "
            f"{(err.square().mean().sqrt() / exact.square().mean().sqrt()).item():.3e}, "
            f"not the rounded product {(got != exact.float()).float().mean().item():.4f}")


def phase_k7_sums(card: str) -> None:
    """Where K7's bf16 early-logit share comes from (``K7_SUMS_CASES``):
    per case and context GEMM group, the kernel against the plain version
    and against the hybrid (the plain recurrence on the kernel GEMM's own
    projection), the hybrid against the plain version; the plain version
    staged on cuBLAS's f32 projection and on the float64 projection
    rounded to f32 against the plain one; the GEMMs' errors against the
    float64 product and their times. Prints only."""
    from inpaintnet_tpu_torch.ops import arnn_kernel as ak

    t0 = time.perf_counter()
    base_group = ak.ARNN_CTX_GROUP
    for hidden, ctx in K7_SUMS_CASES:
        label = f"bf16 H {hidden} C {ctx}"
        params, x, score, force, start = args = _arnn_width_case(hidden, ctx, torch.bfloat16,
                                                                 VOCAB, ARNN_BATCH)
        w_ctx = params["lstm_generation"][0]["w_ih"][start.shape[1]:]
        want = ak.arnn_sampled_decode_reference(*args)

        def early(a, b):
            return ak.decode_agreement(a, b, force)["early_changed"]
        cublas = ak.ctx_projection(x, w_ctx)
        exact = x.double() @ w_ctx.double()
        for name, proj in (("cuBLAS f32", cublas), ("float64 rounded to f32", exact.float())):
            mixed = ak._decode_loop(params, x, score, force, start, proj)
            print(f"[k7-sums] {label}: plain on the {name} projection against plain, early "
                  f"{early(mixed, want):.4f} | {card}", flush=True)
        sub = exact[:K7_SUMS_ROWS]
        print(f"[k7-sums] {label}: cuBLAS f32 GEMM against float64: "
              f"{_gemm_error(cublas[:K7_SUMS_ROWS], sub)}", flush=True)
        del exact, cublas
        first = None
        for group in K7_SUMS_GROUPS:
            ak.ARNN_CTX_GROUP = group
            try:
                got = ak.arnn_sampled_decode(*args)
            finally:
                ak.ARNN_CTX_GROUP = base_group
            call, xwc = _k7_ctx_gemm(x, w_ctx, group)
            hybrid = ak._decode_loop(params, x, score, force, start, xwc)
            ms = cuda_ms(call, 5)
            first = xwc if first is None else first
            print(f"[k7-sums] {label} group {group} (GEMM bit-equal to group "
                  f"{K7_SUMS_GROUPS[0]}'s: {torch.equal(xwc, first)}): early kernel/plain "
                  f"{early(got, want):.4f}, "
                  f"kernel/hybrid {early(got, hybrid):.4f}, hybrid/plain "
                  f"{early(hybrid, want):.4f}; tokens kernel/plain "
                  f"{ak.decode_agreement(got, want, force)['tokens']:.5f}; GEMM {ms:.3f} ms, "
                  f"against float64: {_gemm_error(xwc[:K7_SUMS_ROWS], sub)} | {card}",
                  flush=True)
            del hybrid
        del first, xwc
        torch.cuda.empty_cache()
    print(f"[k7-sums] took {time.perf_counter() - t0:.1f} s", flush=True)


def phase_wide_widths(card: str) -> tuple:
    """Phase 26: K1-K4 above 512 units in bf16 masters. -> ({kernel name:
    {case: entry}} for the kernels line, {kernel: launches} of the wide
    engines, the phase's main path)"""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = _wide_engines(card)
    _wide_entry_points(card)
    entries = {**_wide_encoders(card), **_wide_decoders(card)}
    torch.cuda.empty_cache()
    print(f"[wide] phase 26 took {time.perf_counter() - t0:.1f} s", flush=True)
    return entries, launches


def phase_hidden_widths(card: str) -> tuple:
    """Phase 25: the widths that run on zero units, and K5/K6 at 1024. ->
    ({kernel name: {case: entry}} for the kernels line, {kernel: launches}
    of the training step and of the narrow engines, the phase's main
    paths)"""
    t0 = time.perf_counter()
    launches = _narrow_engines(card)
    entries = {**_narrow_encoders(card), **_narrow_decoders(card)}
    entries["arnn_sampled_decode"] = _narrow_arnn(card)
    entries["gru_layer_stream"] = _narrow_k8(card)
    entries.update(_narrow_train(card))
    launches.update(_width_training_step(card))
    print(f"[widths] phase 25 took {time.perf_counter() - t0:.1f} s", flush=True)
    return entries, launches


# ---------------------------------------------------------------------------
# Phase 28: K8, K5 and K6 above 1,024 units, on tile groups whose CTAs span
# clusters (kernel_common.tile_plan), and the LatentRNN of hidden 768
# (train_inpaintnet.py --latent_rnn_hidden_size 768), whose 2-layer
# generation bi-GRU is 1,536 wide
# ---------------------------------------------------------------------------
WIDE_LATENT_H = 768
WIDE_GEN_H = 2 * WIDE_LATENT_H  # the generation GRU: hidden x 2 layers
# K8's shapes at H 1,536 (label, rows, steps, mask): the engine's batch-2048
# generation call (6 target measures), the autoregressive step, a batch-1
# call
WIDE_K8_SHAPES = (("generation", BATCH, 6, "target"), ("step", BATCH, 1, None),
                  ("batch 1", 1, 6, "target"))
# K5 / K6 (rows, steps): the autoregressive sampled step's calls (32
# windows, one target step) and the engine-sized batch over 6 steps
WIDE_TRAIN_SHAPES = ((LATENT_WINDOWS, 1), (BATCH, 6))
WIDE_FAULT_ROWS = 256  # rows of the planted exchange faults (6 steps, f32)
WIDE_ENGINE_BUCKETS = (1, BATCH)
WIDE_TRAIN_COINS = (True, False, True, False)  # a compute dtype's steps, heads first


@contextlib.contextmanager
def _tile_route(route):
    """Every K5, K6 and K8 launch on ``route`` ("group", "step"; None: the
    plan's) inside the block (``kernel_common.tile_route``)."""
    from inpaintnet_tpu_torch.ops import kernel_common as kc

    real = kc.tile_route
    kc.tile_route = lambda: route
    try:
        yield
    finally:
        kc.tile_route = real


@contextlib.contextmanager
def _group_fault(fault: int):
    """A planted fault in every tile-group launch inside the block
    (``kernel_common.group_fault``: 1 the other parity buffer's pieces, 2
    one arrival short with the last CTA paused)."""
    from inpaintnet_tpu_torch.ops import gru_kernel, gru_train_kernel, kernel_common

    modules = (kernel_common, gru_kernel, gru_train_kernel)
    real = [m.group_fault for m in modules]
    for m in modules:
        m.group_fault = lambda: fault
    try:
        yield
    finally:
        for m, f in zip(modules, real):
            m.group_fault = f


def _same_outputs(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def _wide_k8(card: str) -> dict:
    """K8 at ``WIDE_K8_SHAPES`` x H 1,536, f32 and bf16, against its plain
    version within ``gru_kernel.BOUNDS`` (one launch, the group route); its
    time beside its bound, the plain version's, cuDNN's one-direction GRU
    and the eager loop's device time on the same inputs; at the bf16
    generation shape also the same layer on one launch a step, bit-equal
    to the group route, timed. -> {case: entry}"""
    from inpaintnet_tpu_torch.ops import gru as gru_mod
    from inpaintnet_tpu_torch.ops import gru_kernel as lk

    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        for i, (label, rows, steps, mask_kind) in enumerate(WIDE_K8_SHAPES):
            args = _gru_layer_inputs(280 + i, rows, steps, WIDE_GEN_H, dtype, mask_kind)
            plan = lk.tile_plan_of(rows, WIDE_GEN_H, dtype, args[0].device)
            before = lk.gru_layer_stream.launches
            got = lk.gru_layer_stream(*args)
            launched = lk.gru_layer_stream.launches - before
            want = lk.gru_layer_reference(*args)
            torch.cuda.synchronize()
            agree = lk.agreement(got, want)
            case = f"{kind} {label} rows {rows} steps {steps} H {WIDE_GEN_H}"
            if not (lk.within(agree, lk.BOUNDS[dtype]) and launched == 1
                    and plan.route == "group"):
                raise RuntimeError(f"K8 {case}: {agree} (bounds {lk.BOUNDS[dtype]}), {launched} "
                                   f"launches, plan {plan}")
            ms = cuda_ms(lambda: lk.gru_layer_stream(*args), 5)
            plain_ms = cuda_ms(lambda: lk.gru_layer_reference(*args), 1)
            library_ms = cudnn_gru_layer_ms(args, dtype)
            eager_ms = _profile_step(lambda: gru_mod._eager_layer(*args, reverse=False,
                                                                  want_ys=True))[0]
            moved = nbytes([a for a in args if a is not None], list(got))
            ops = gru_layer_ops(rows, steps, WIDE_GEN_H)
            b = bound_of(ops, kind, moved)
            if dtype == torch.float32:  # the split passes' bound, beside the FMA units'
                b = {**bound_of(6 * ops, "bf16", moved), "bound_f32_fma_ms": b["bound_ms"]}
            extra = {}
            if dtype == torch.bfloat16 and label == "generation":
                with _tile_route("step"):
                    if not _same_outputs(lk.gru_layer_stream(*args), got):
                        raise RuntimeError(f"K8 {case}: the step route differs from the group "
                                           "route")
                    extra["step_ms"] = cuda_ms(lambda: lk.gru_layer_stream(*args), 5)
            entries[case] = {"max_abs_err": agree["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                             **b, "library_ms": library_ms, "eager_device_ms": eager_ms,
                             "plan": list(plan), "launches": launched, **extra}
            print(f"[wide] gru_layer_stream {case}: {agree} (bounds {lk.BOUNDS[dtype]}), plan "
                  f"{plan}; kernel {ms:.3f} ms"
                  + "".join(f", {k[:-3]} route {v:.3f} ms (bit-equal)" for k, v in extra.items())
                  + f", plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                  f"cuDNN torch.nn.GRU({GRU_YARDSTICK_IN}, {WIDE_GEN_H}) one direction, "
                  f"unmasked, {library_ms:.3f} ms, the eager loop's device time {eager_ms:.3f} "
                  f"ms | {card}", flush=True)
    return entries


def _wide_train(card: str) -> dict:
    """K5 and K6 at ``WIDE_TRAIN_SHAPES`` x H 1,536, f32 and bf16, on tile
    groups, K6 on K5's gates: against the plain versions (``TRAIN_BOUNDS``),
    one launch each, timed beside their bounds and plain versions.
    -> {kernel: {case: entry}}"""
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk

    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        for rows, steps in WIDE_TRAIN_SHAPES:
            fwd, dys = _train_kernel_case(rows + steps, rows, steps, WIDE_GEN_H, dtype, False)
            before = (gk.gru_fwd_seq.launches, gk.gru_bwd_seq.launches)
            out, grads, hprev = _run_k5_k6(fwd, dys, False, gk)
            launched = (gk.gru_fwd_seq.launches - before[0], gk.gru_bwd_seq.launches - before[1])
            want_out = gk.gru_fwd_seq_reference(*fwd)
            want_grads = gk.gru_bwd_seq_reference(fwd[0], dys, *out[1:], hprev)
            torch.cuda.synchronize()
            bounds = _k5_k6_bounds(steps, rows, WIDE_GEN_H, dtype, fwd, out, grads, dys, hprev)
            case = f"{kind} rows {rows} steps {steps} H {WIDE_GEN_H}"
            calls = ((gk.gru_fwd_seq, out, want_out, lambda: gk.gru_fwd_seq(*fwd),
                      lambda: gk.gru_fwd_seq_reference(*fwd), bounds[0],
                      gk.fwd_tile_plan(rows, WIDE_GEN_H, dtype, fwd[0].device)),
                     (gk.gru_bwd_seq, grads, want_grads,
                      lambda: gk.gru_bwd_seq(fwd[0], dys, *out[1:], hprev),
                      lambda: gk.gru_bwd_seq_reference(fwd[0], dys, *out[1:], hprev), bounds[1],
                      gk.bwd_tile_plan(rows, WIDE_GEN_H, dtype, fwd[0].device)))
            for (kernel, got, want, call, plain, bound, plan), n in zip(calls, launched):
                e_max, e_mean, e_abs = _train_kernel_errs(got, want)
                ok = e_max <= TRAIN_BOUNDS[dtype][0] and e_mean <= TRAIN_BOUNDS[dtype][1]
                if not ok or n != 1 or plan.route != "group":
                    raise RuntimeError(f"{kernel.__name__} {case}: max {e_max:.3e} mean "
                                       f"{e_mean:.3e} (bounds {TRAIN_BOUNDS[dtype]}), {n} "
                                       f"launches, plan {plan}")
                ms, plain_ms = cuda_ms(call, 5), cuda_ms(plain, 1)
                entries.setdefault(kernel.__name__, {})[case] = {
                    "max_abs_err": e_abs, "ms": ms, "plain_ms": plain_ms, **bound,
                    "library_ms": None, "plan": list(plan), "launches": n}
                print(f"[wide] {kernel.__name__} {case}: max {e_max:.3e} mean {e_mean:.3e} "
                      f"(bounds {TRAIN_BOUNDS[dtype]}), plan {plan}; kernel {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}"
                      f"), library none | {card}", flush=True)
    return entries


def _wide_faults(card: str) -> None:
    """The group exchange's two planted faults (a consumer reading the
    other parity buffer's pieces; one arrival short, the last CTA paused)
    in K8, K5 and K6 at H 1,536, ``WIDE_FAULT_ROWS`` rows x 6 steps, f32:
    each must leave its bounds; unplanted, each is within them."""
    from inpaintnet_tpu_torch.ops import gru_kernel as lk
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk

    args = _gru_layer_inputs(288, WIDE_FAULT_ROWS, 6, WIDE_GEN_H, torch.float32, "target")
    fwd, dys = _train_kernel_case(289, WIDE_FAULT_ROWS, 6, WIDE_GEN_H, torch.float32, False)
    want8 = lk.gru_layer_reference(*args)
    want5 = gk.gru_fwd_seq_reference(*fwd)
    hprev = torch.cat([fwd[3][None], want5[0][:-1]])
    want6 = gk.gru_bwd_seq_reference(fwd[0], dys, *want5[1:], hprev)
    bound = TRAIN_BOUNDS[torch.float32]
    for fault in (0, 1, 2):
        with _group_fault(fault):
            k8 = lk.agreement(lk.gru_layer_stream(*args), want8)
            k5 = _train_kernel_errs(gk.gru_fwd_seq(*fwd), want5)
            k6 = _train_kernel_errs(gk.gru_bwd_seq(fwd[0], dys, *want5[1:], hprev), want6)
            torch.cuda.synchronize()
        inside = (lk.within(k8, lk.BOUNDS[torch.float32]),
                  k5[0] <= bound[0] and k5[1] <= bound[1], k6[0] <= bound[0] and k6[1] <= bound[1])
        name = ("none", "the other parity buffer", "one arrival short")[fault]
        print(f"[wide] planted exchange fault {name}: K8 {k8}, K5 max/mean {k5[0]:.3e}/"
              f"{k5[1]:.3e}, K6 {k6[0]:.3e}/{k6[1]:.3e}; within the bounds {inside} | {card}",
              flush=True)
        if inside != ((True,) * 3 if fault == 0 else (False,) * 3):
            raise RuntimeError(f"the planted exchange fault {name}: within the bounds {inside}")


def _wide_refused(card: str) -> None:
    """K8 bf16 at H 1,536 on one tile group more than the card holds at
    once (the plan forced): the cooperative launch must refuse the grid
    (``cudaErrorCooperativeLaunchTooLarge``, 720) instead of leaving a group
    to wait on a peer that never starts; the card then runs the plan's own
    launch within the bounds."""
    from inpaintnet_tpu_torch.ops import gru_kernel as lk
    from inpaintnet_tpu_torch.ops.kernel_common import HOPPER_ROWS, TilePlan

    dtype = torch.bfloat16
    full = lk.tile_plan_of(64 * HOPPER_ROWS, WIDE_GEN_H, dtype, torch.device("cuda"))
    args = _gru_layer_inputs(290, HOPPER_ROWS * (full.groups + 1), 2, WIDE_GEN_H, dtype,
                             "target")
    real = lk.tile_plan_of
    lk.tile_plan_of = lambda *a: TilePlan("group", full.ctas, full.groups + 1)  # noqa: E731
    try:
        lk.gru_layer_stream(*args)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    finally:
        lk.tile_plan_of = real
    agree = lk.agreement(lk.gru_layer_stream(*args), lk.gru_layer_reference(*args))
    torch.cuda.synchronize()
    print(f"[wide] K8 bf16 H {WIDE_GEN_H} on {full.groups + 1} groups of {full.ctas} CTAs (the "
          f"card holds {full.groups}): {refused or 'not refused'}; then the plan's launch "
          f"{agree} | {card}", flush=True)
    if refused is None or not refused.endswith("cudaError_t 720") \
            or not lk.within(agree, lk.BOUNDS[dtype]):
        raise RuntimeError(f"a group grid past the card: {refused}, then {agree}")


def _wide_width_launches(call) -> tuple:
    """-> (call(), {hidden size: K8 launches by ops/gru.py's "pallas" route
    during it}, eager GRU steps of width ``WIDE_GEN_H``)"""
    from inpaintnet_tpu_torch.ops import gru as gru_mod

    real, widths = gru_mod.gru_layer_stream, {}

    def counted(xw, w_hh, *rest, **kw):
        widths[w_hh.shape[0]] = widths.get(w_hh.shape[0], 0) + 1
        return real(xw, w_hh, *rest, **kw)

    gru_mod.gru_layer_stream = counted
    try:
        out, steps = _eager_gru_steps(call, WIDE_GEN_H)
    finally:
        gru_mod.gru_layer_stream = real
    return out, widths, steps


def _wide_layer_engines(card: str) -> dict:
    """The 768 LatentRNN (over the flagship VAE, random weights from seed
    0) on ``"pallas"``: the f32 main path on the card against the CPU
    (``phase_reference``); its engines in bf16 and f32 masters and the
    autoregressive one in bf16, a batch-2048 call (6/4/6) and a batch-1
    call (7/2/7) each, on the eager route (K8 launches a call by width: the
    generation GRU's 2 layers x 2 directions at 1,536, once or once a
    target step; no eager step of that width) and on the graph route
    (capture, replay; tokens and launches equal to the eager route's); the
    graphs' pool (``GraphSet.held_bytes``) and the replays' times.
    -> {kernel: launches} of the replays"""
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops.gru import gru_impl_scope
    from inpaintnet_tpu_torch.serve import InpaintingEngine

    totals = {}
    for auto_reg, dtypes in ((False, ("bfloat16", "float32")), (True, ("bfloat16",))):
        model = build_flagship(seed=0, device="cuda", auto_reg=auto_reg,
                               latent_hidden=WIDE_LATENT_H)[2]
        if model.gen_hidden_size != WIDE_GEN_H:
            raise RuntimeError(f"the 768 LatentRNN's generation GRU is {model.gen_hidden_size}")
        if not auto_reg:
            with gru_impl_scope("pallas"):
                phase_reference(model, quantized=False)
        for dtype in dtypes:
            engine = InpaintingEngine(model, batch_buckets=WIDE_ENGINE_BUCKETS, dtype=dtype,
                                      device="cuda")
            mt = engine.max_target
            rng = np.random.default_rng(28)
            big = _request(rng, BATCH, N_PAST, N_TARGET, N_FUTURE)
            one = _request(rng, 1, 7, 2, 7)
            calls = [(f"batch {BATCH}", lambda: engine.inpaint(*big, seed=11)),
                     ("batch 1", lambda: engine.inpaint(*one, seed=11))]
            label = f"768 LatentRNN{' autoregressive' if auto_reg else ''} {dtype}"
            want = {WIDE_GEN_H: 4 * (mt if auto_reg else 1)}
            with gru_impl_scope("pallas"):
                with _route(engine, False):
                    for name, call in calls:
                        out, widths, steps = _wide_width_launches(call)
                        _check_response(out, *(big if name != "batch 1" else one))
                        total = k8_launches_per_call(mt, auto_reg)
                        if widths.get(WIDE_GEN_H) != want[WIDE_GEN_H] or steps != 0 \
                                or sum(widths.values()) != total:
                            raise RuntimeError(f"{label} {name}: K8 launches by width {widths} "
                                               f"(expected {want} of {total}), {steps} eager "
                                               f"steps of width {WIDE_GEN_H}")
                        print(f"[wide] {label} {name} (eager route): K8 launches by width "
                              f"{widths}, eager steps of width {WIDE_GEN_H}: {steps}", flush=True)
                _check_routes(engine, label, calls, totals)
                pool = engine._graphs.held_bytes() / 2**30
                t_big = cuda_ms(calls[0][1], 3)
                lat = [cuda_ms(calls[1][1], 1) for _ in range(10)]
            print(f"[time] {label} pallas (graphs) batch {BATCH} 6/4/6: {t_big:.2f} ms per "
                  f"call, {BATCH * N_TARGET / (t_big / 1e3):.1f} measures/s; batch 1 p50 "
                  f"{np.median(lat):.2f} ms (p90 {np.percentile(lat, 90):.2f}); the graphs' "
                  f"pool holds {pool:.3f} GiB | {card}", flush=True)
            del engine
            torch.cuda.empty_cache()
        del model
    return totals


def _wide_trainer(card: str) -> dict:
    """The autoregressive 768 LatentRNN trainer at ``train_inpaintnet.py``'s
    defaults (32 windows of 16 bars, dropout 0.5, lr 1e-4), f32 and bf16
    compute, ``WIDE_TRAIN_COINS`` steps each: K2 / K5 / K6 launches a step
    as ``latent_train_launches`` says (the sampled branch's unmasked
    1,536-wide generation GRU on K5 / K6, no eager step of that width; the
    teacher-forced branch's masked one on the eager loop), finite losses,
    the parameters moved. -> {kernel: launches}"""
    from inpaintnet_tpu_torch.models.base import iter_leaves
    from inpaintnet_tpu_torch.models.presets import build_flagship
    from inpaintnet_tpu_torch.ops import decode_kernel
    from inpaintnet_tpu_torch.ops import gru_train_kernel as gk
    from inpaintnet_tpu_torch.train import LatentRNNTrainer
    from inpaintnet_tpu_torch.train.data import ArrayDataset

    rng = np.random.default_rng(28)
    windows = rng.integers(0, VOCAB, (LATENT_WINDOWS, 1, N_BARS * 24)).astype(np.int32)
    _, _, model = build_flagship(seed=0, device="cuda", auto_reg=True,
                                 latent_hidden=WIDE_LATENT_H)
    mt = model.max_target
    kernels = (decode_kernel.decode_sampling, gk.gru_fwd_seq, gk.gru_bwd_seq)
    totals = dict.fromkeys((k.__name__ for k in kernels), 0)
    for compute in (None, "bfloat16"):
        tr = LatentRNNTrainer(ArrayDataset((windows,), N_BARS), model, lr=1e-4, device="cuda",
                              compute_dtype=compute, seed=1)
        start = [p.detach().clone() for _, p in iter_leaves(tr.params)]
        walls = {}
        for coin in WIDE_TRAIN_COINS:
            batch = tr.process_batch_data((windows,))
            before = [k.launches for k in kernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loss, _), eager = _eager_gru_steps(lambda: tr.train_step(batch, coin=coin),
                                                WIDE_GEN_H)
            loss = loss.item()
            walls.setdefault(coin, []).append((time.perf_counter() - t0) * 1e3)
            got = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
            want = latent_train_launches(True, coin, mt)
            want_eager = 0 if coin is False else 4 * mt
            if got != want or eager != want_eager or not np.isfinite(loss):
                raise RuntimeError(f"768 trainer {compute or 'float32'} coin {coin}: launches "
                                   f"{got} (expected {want}), {eager} eager steps of width "
                                   f"{WIDE_GEN_H} (expected {want_eager}), loss {loss}")
            for k, n in got.items():
                totals[k] += n
        moved = sum((p.detach() - s).abs().sum().item()
                    for (_, p), s in zip(iter_leaves(tr.params), start))
        if not moved > 0:
            raise RuntimeError("the 768 LatentRNN's parameters did not move")
        print(f"[wide] 768 autoregressive trainer {compute or 'float32'}: ms a step (the first "
              f"of each branch warms up) teacher-forced {[round(w, 1) for w in walls[True]]}, "
              f"sampled {[round(w, 1) for w in walls[False]]}; launches a sampled step "
              f"{latent_train_launches(True, False, mt)}, no eager step of width {WIDE_GEN_H} "
              f"there; last loss {loss:.5f} | {card}", flush=True)
        del tr, start
        torch.cuda.empty_cache()
    del model
    return totals


def phase_wide_layers(card: str) -> tuple:
    """Phase 28: K8, K5 and K6 above 1,024 units and the 768 LatentRNN.
    The kernels at H 1,536 against their plain versions and the planted
    faults first; then the main paths (the engines and the trainer), every
    launch count set to 0 before them and read after. -> ({kernel name:
    {case: entry}} for the kernels line, {kernel: launches} of the main
    paths)"""
    t0 = time.perf_counter()
    entries = {"gru_layer_stream": _wide_k8(card), **_wide_train(card)}
    _wide_faults(card)
    _wide_refused(card)
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    launches = _wide_layer_engines(card)
    train = _wide_trainer(card)
    counted = {name: k.launches for name, k in kernels.items()}
    if min(counted[n] for n in ("gru_layer_stream", "gru_fwd_seq", "gru_bwd_seq")) < 1:
        raise RuntimeError(f"phase 28's main paths launched {counted}")
    launches = {**launches, **{k: n for k, n in train.items() if k != "decode_sampling"}}
    print(f"[wide] phase 28 launches: the engines' replays and the trainer's steps {launches}, "
          f"all wrappers in the phase's main paths {counted}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return entries, launches


def _clocked(phase):
    """``phase`` printing its wall seconds when it returns (``[clock]``):
    where the run's 1,200 s go."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return phase(*args, **kwargs)
        finally:
            print(f"[clock] {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return run


for _name, _phase in list(globals().items()):
    if _name.startswith("phase_") and callable(_phase):
        globals()[_name] = _clocked(_phase)


def main() -> int:
    t_run = time.perf_counter()
    cli = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    cli.add_argument("--parent", metavar="DIR",
                     help="an earlier checkout of this repository whose V 60 decode kernels "
                          "(K2, K4, K7) are timed beside this tree's, in turns")
    cli.add_argument("--first-port", metavar="DIR",
                     help="a checkout from before the Hopper f32 routes, whose first f32 K2 "
                          "and K8 kernels are built and timed beside the new ones")
    cli.add_argument("--kernel-times", metavar="DIR",
                     help="only print the V 60 decode kernels' times of the checkout at DIR "
                          "as one JSON line (what --parent runs in a process of its own)")
    cli.add_argument("--route-outputs", nargs=2, metavar=("DIR", "OUT"),
                     help="only save the outputs of ROUTE_CASES through the wrappers of the "
                          "checkout at DIR to OUT and print their times as one JSON line (what "
                          "--parent runs in a process of its own)")
    cli.add_argument("--parent-only", action="store_true",
                     help="with --parent, run only the comparisons with the parent and exit")
    cli.add_argument("--engine-times", metavar="DIR",
                     help="only print the 768 LatentRNN bf16 engine's times through the "
                          "checkout at DIR as one JSON line (what --parent runs in a process "
                          "of its own)")
    cli.add_argument("--k7-sums", action="store_true",
                     help="only take K7's bf16 sums apart at wide contexts and units "
                          "(phase_k7_sums), printing what each GEMM and recurrence changes")
    opts = cli.parse_args()
    card = phase_device()
    if opts.kernel_times:
        print(json.dumps(kernel_times(opts.kernel_times)))
        return 0
    if opts.route_outputs:
        print(json.dumps(route_outputs(*opts.route_outputs)))
        return 0
    if opts.engine_times:
        print(json.dumps(engine_times(opts.engine_times)))
        return 0
    phase_build()
    if opts.k7_sums:
        phase_k7_sums(card)
        return 0
    if opts.parent:
        parent = str(Path(opts.parent).resolve())  # each child runs from its own root
        phase_parent_routes(parent, card)
        phase_parent_times(parent, card)
        phase_parent_engines(parent, card)
        if opts.parent_only:
            return 0
    parent = None if opts.first_port is None else ParentKernels(opts.first_port)
    from inpaintnet_tpu_torch.models.presets import build_flagship

    _, vae, model = build_flagship(seed=0, device="cuda", dtype=torch.float32)
    report = phase_kernels(vae, model.max_target, card, parent)
    report.update(phase_train_kernels(card))
    # before any engine holds a CUDA graph's memory pool, which the cache
    # cannot hand back to cuDNN's 22 GiB GRU at H 577 x 65,536 rows
    wide_entries, launches_wide = phase_wide_widths(card)
    # its engines hold graph pools only until the phase ends
    layer_entries, launches_layers = phase_wide_layers(card)
    phase_reference(model)
    engine16, launches, span_bf16 = phase_engine(model, "bfloat16", card)
    engine8, launches8, span_int8 = phase_engine(model, "int8", card)
    print(f"[engine] int8 and bf16 agree on {(span_int8 == span_bf16).mean():.4f} of the "
          f"batch-{BATCH} span tokens (random weights: printed, no limit)", flush=True)
    launches_f32 = phase_f32_engine(model, card)
    launches_http = phase_http(engine8, card)
    from inpaintnet_tpu_torch.models.presets import build_arnn

    arnn = build_arnn(seed=0, device="cuda")
    report.update(phase_arnn_kernel(arnn, card))
    phase_arnn_reference()
    arnn_engine, launches_arnn = phase_arnn_engine(arnn, card)
    launches_arnn_http = phase_arnn_http(engine8, arnn_engine, card)
    del engine8, arnn_engine
    torch.cuda.empty_cache()
    vocab_entries, launches_vocab = phase_vocab_heads(vae, arnn, card)
    report.update(phase_gru_layer_kernel(card, parent))
    phase_gru_routes(engine16, card)
    del engine16
    phase_autoreg_reference(card)
    ar_engine, launches_ar = phase_autoreg_engine(card)
    launches_ar_http = phase_autoreg_http(ar_engine, card)
    del ar_engine
    torch.cuda.empty_cache()
    launches_graphs = phase_graphs(model, arnn, card)
    del arnn
    torch.cuda.empty_cache()
    phase_train_reference(card)
    launches_train = phase_trainer(card)
    phase_latent_train_reference(card)
    launches_latent = phase_latent_trainer(card)
    launches_arnn_train = phase_arnn_training(card)
    launches_eval = phase_cli(card)
    train_mode = phase_training_surface(model, card)
    launches_tp = phase_tensor_parallel(card)
    width_entries, launches_width = phase_hidden_widths(card)
    arnn_width_entries, launches_arnn_widths, k8_gradient = phase_arnn_widths(card)
    sources = {
        "encoder_hn": ("encoder_gru.cu", "inpaintnet_tpu/ops/encoder_pallas.py:147", launches),
        "decode_sampling": ("decode_sampling.cu", "inpaintnet_tpu/ops/decode_pallas.py:216",
                            launches),
        "encoder_hn_int8": ("encoder_gru_int8.cu", "inpaintnet_tpu/ops/encoder_pallas.py:437",
                            launches8),
        "decode_sampling_int8": ("decode_sampling_int8.cu",
                                 "inpaintnet_tpu/ops/decode_pallas.py:451", launches8),
        "gru_fwd_seq": ("gru_fwd_seq.cu", "inpaintnet_tpu/ops/gru_bwd_pallas.py:104",
                        launches_train),
        "gru_bwd_seq": ("gru_bwd_seq.cu", "inpaintnet_tpu/ops/gru_bwd_pallas.py:161",
                        launches_train),
        "arnn_sampled_decode": ("arnn_decode.cu", "inpaintnet_tpu/ops/arnn_pallas.py:132",
                                launches_arnn),
        "gru_layer_stream": ("gru_layer.cu", "inpaintnet_tpu/ops/gru_pallas.py:82", launches_ar),
    }
    for name in ("decode_sampling", "gru_layer_stream"):  # the f32 engine's calls
        report[name]["f32"]["launches"] = launches_f32[name]
    kernels = [{"name": name, "route": "cuda",
                "source": f"inpaintnet_tpu_torch/ops/csrc/{src}", "replaces": replaces,
                "launches": runs[name], **report[name],
                "latent_train_launches": launches_latent.get(name, 0),
                "arnn_train_launches": launches_arnn_train.get(name, 0),
                "eval_launches": launches_eval.get(name, 0),
                "graph_launches": launches_graphs.get(name, 0),
                **({"tp_launches": launches_tp[name]} if name in launches_tp else {}),
                **({"vocab_heads": vocab_entries[name],
                    "vocab_engine_launches": launches_vocab.get(name, 0)}
                   if name in vocab_entries else {}),
                "hidden_widths": width_entries[name],
                **({"width_launches": launches_width[name]}
                   if name in launches_width else {}),
                **({"wide_widths": wide_entries[name],
                    "wide_launches": launches_wide[name]} if name in wide_entries else {}),
                **({"wide_layers": layer_entries[name],
                    "wide_layer_launches": launches_layers.get(name, 0)}
                   if name in layer_entries else {})}
               for name, (src, replaces, runs) in sources.items()]
    # K1's training mode (phase 21): its launches in the VAE steps under the
    # switch, its time and bound at the VAE step's rows, cuDNN as library_ms
    kernels[0]["train_mode"] = train_mode
    # K8's kernel also serves the two TPU kernels of the same function (K9, K10)
    kernels[-1]["also_replaces"] = ["inpaintnet_tpu/ops/gru_pallas.py:296",
                                    "inpaintnet_tpu/ops/gru_pallas.py:363"]
    # phase 27: K7 at C above 512 and bf16 H 513-640, its engine's replays;
    # K8's launches under a gradient
    kernels[6]["arnn_widths"] = arnn_width_entries
    kernels[6]["arnn_widths_launches"] = launches_arnn_widths.get("arnn_sampled_decode", 0)
    kernels[-1]["gradient"] = k8_gradient
    print(f"[launches] HTTP path: {launches_http}; ARNN HTTP path: {launches_arnn_http}; "
          f"autoregressive HTTP path: {launches_ar_http}", flush=True)
    print(f"[profile] lead kernels the traces lost: {LEADS_LOST[0]} of {LEADS_LOST[1]}",
          flush=True)
    print(f"[clock] the run: {time.perf_counter() - t_run:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
