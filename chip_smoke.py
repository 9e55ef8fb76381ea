#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: nvcc builds every kernel of the port's paths from the sources
   in this checkout (``src/repro_torch/csrc``) for sm_90a, one nvcc per
   source, all started together; every bf16 instance of the flash kernel
   (head dims 64, 96, 120, 128, 256, one or two warpgroups) must show
   HGMMA (wgmma) and every bf16 instance of the decode kernel (64, 120,
   128, 256) HMMA (mma.sync) in ``cuobjdump -sass``, and none of them,
   nor either instance of the rglru_scan kernel (fp32, bf16; no tensor
   cores), may spill in ptxas's report; the two backward sources are
   built with them: every bf16 instance of ``flash_attention_bwd.cu``
   (the dQ kernel at head dims 64, 96, 120, 128 with one or two
   warpgroups and 256 with one; the dK/dV kernel at the five head dims)
   must show HGMMA and no spill, and neither instance of
   ``rglru_scan_bwd.cu`` (fp32, bf16) may spill; flash's fp32 backward
   instances (3 passes x 5 head dims, CUDA cores) have their registers
   and spills printed (a spill is reported, not failed);
3. kernels: flash_attention, decode_attention and rglru_scan, each
   against its plain PyTorch version on the card, at the test shapes, the
   shapes the paths give them (flash also on the paths' own layout:
   transposed views of [B, S, H, D]), ragged, tiling-edge, all-masked and
   long cases, in fp32 (tolerance 2e-5; rglru_scan 1e-4) and bf16 (2e-2;
   bf16 flash and decode also within 2 ** -6 of the plain output's size,
   per element: |kernel - plain| / (|plain| + rms of the plain row over
   D)); all-masked decode rows give mean(v); decode's split plan at each
   case (splits, CTAs, stages, shared and partial bytes) and rglru_scan's
   scan plan (column tile, segments, threads, blocks, CTAs), its rows a
   thread held to the library's; rglru_scan also at S = 1, S one around
   a block and two, W off the column tile, B 1 at S 8192 and bf16 at the
   prompt; this slice's paths: D 120 flash at h2o-danube-3-4b's serving
   and prompt shapes (and D 128 at the same shapes), non-causal
   cross-attention of 48 and of 1 row over 1024 frames and the 1024-frame
   encoder (seamless-m4t-medium), llava-next's 2881-token sequence, D 120
   decode on h2o's wrapped 4096-slot ring (and D 128), seamless's and
   llava's decode caches; prints the error and the median times of the
   kernel, the plain version and one PyTorch library call of the same
   function where there is one (a yardstick only), beside the least time
   the card could take (bytes over 3.35 TB/s or operations over the peak
   rate of the input type, whichever is larger; decode's bytes are the
   K/V rows of its valid slots); then the backward
   kernels, reached through autograd, against autograd of their plain
   versions on the card: flash at the test shapes, ragged S, GQA and
   MQA, non-causal cross-attention Sq 48 / Sk 1024, all-masked rows,
   D 120 and the train shapes (qwen3-4b's layer B2 S2048 D128 and the
   hybrid's attention block at S 2100 across its 2048 window), in fp32
   and bf16 (each gradient within 1e-4 / 2e-2 of |plain| + its rms; the
   plain version runs in fp32 on the same inputs and rounds once; the
   launch plan and exact kernel counts, 2 a call in bf16 and 3 in fp32;
   at the bf16 train shapes a second call must give bitwise-equal
   gradients); rglru_scan with and without h0, at S = 1, ragged, S one
   around one and two of its backward plan's blocks, W off the column
   tile, and the hybrid's [2, 2100, 4096] (fp32 and bf16; the backward
   plan printed per case, its rows and threads held to the library's; at
   the train shape a second call must give bitwise-equal gradients); the
   backward kernel's time, the plain backward's, SDPA's backward (flash
   only) and the bound; llama4-scout-17b-a16e's shapes (40 query heads
   over 8 kv heads, G 5): flash at its serving shape (B2 S48, chunked
   and full layers, fp32 and bf16) and its 8320-token prompt (the 8192
   chunk border inside a tile; chunked and full), decode on its wrapped
   8192-slot ring (chunk 8192: 144 slots valid; full: all), flash's
   backward at B2 S2048 (no head split) and B1 S1024 (a head split of
   5), both bitwise repeatable; flash's forward plan (warpgroups, CTAs)
   is printed with every bf16 case;
4. train: (a) qwen3-4b at full width cut to 2 layers and (c)
   recurrentgemma-9b at full width cut to one (rec, rec, attn) pattern,
   B2 S2048 / S2100, one step's loss and every parameter's gradient
   through the kernels against the same step on the plain versions
   (each gradient within 5e-2 of its norm), launches exact (flash twice
   a layer under remat, its backward 2 kernels a call in bf16;
   rglru_scan's backward once a rec block); (c)'s step (forward, loss and
   gradients through the kernels) is also timed, the median of 3 on the
   host clock, each ending in a synchronising read of its loss; (b)
   full-width, full-depth qwen3-4b
   (remat on): 4 steps of the synthetic pipeline through
   ``launch.train.train`` (no mesh: the un-meshed step, which phase 11
   (e) holds the meshed one to) at B2 S2048 (B1
   if the reckoned peak does not fit), finite losses and grad norms,
   parameters moved (how many tensors, and the norm gains, which start
   at zero), exact flash launches, time per step, tokens/s and peak
   memory; (d) one full-width llama4-scout-17b-a16e layer of each kind
   (chunked, full) at B2 S2048: the gradients of a fixed scalar of its
   output plus its aux loss with respect to every parameter and x,
   through the kernels (flash's launches exact), against the plain
   versions given the same expert choices (``routed_as``), each within
   5e-2 of its norm; one full-width deepseek-v2-236b layer (MLA and MoE,
   no kernel): every gradient finite and non-zero;
5. model: full-width, full-depth qwen3-4b, stablelm-1.6b,
   recurrentgemma-9b, granite-20b, mamba2-2.7b, h2o-danube-3-4b,
   seamless-m4t-medium and llava-next-mistral-7b (random bf16 weights
   from a seed) give finite logits of the right shape; one layer of each
   dense model and of llava, one rec and one attn block of the hybrid,
   and one encoder and one decoder layer (self- and cross-attention) of
   seamless agree with the same block run on the plain versions; mamba2,
   which runs no kernel, is held to itself in its two forms: each layer's
   chunked scan over S tokens against the recurrent decode of the last
   token from the cache of the first S - 1 (the whole model's
   last-position logits from prefill + ``decode_step`` are reported
   beside ``forward``'s); the MoE family at full width cut in depth
   (``MOE_CUTS``, registered as ``llama4-scout-17b-a16e-L8`` and
   ``deepseek-v2-236b-L6``): finite logits and aux; llama4's first
   chunked and first full layer against the plain versions (given the
   same expert choices), two calls of each giving the same bits;
   deepseek, which runs no kernel, held to itself in its two forms: the
   last position's logits of prefill + ``decode_step`` against
   ``forward`` (B1 S8, where no entry can be dropped past capacity; the
   same expert choices) within MOE_FORMS_TOL of max|logit|, and its MLA
   sublayer alone at the generate shape (B2, prefill of 1024 tokens and
   16 decode steps against the full form over 1040) within
   MLA_FORMS_TOL of max|full|;
6. generate: prefill then 16 ``decode_step``s of full-width qwen3-4b
   (B2, prompt 1024), recurrentgemma-9b (B2, prompt 2100, past its 2048
   window, so the cache is a wrapped ring) and mamba2-2.7b (B2, prompt
   2048, a multiple of its 256-token SSD chunk), h2o-danube-3-4b (B2,
   prompt 4160, past its 4096 window: a wrapped D 120 ring),
   seamless-m4t-medium (B2, 1024 frames + 64 tokens) and
   llava-next-mistral-7b (B2, 2880 patches + 64 tokens; these three with
   wq and wk at fan_in d_model, ``rescale_qk``), llama4-scout-17b-a16e
   cut to one chunk-pattern group (B1, prompt 8320: every layer's
   8192-slot ring wraps, the full layer's too) and deepseek-v2-236b cut
   to 6 layers (B2, prompt 1024; no kernel: flash and decode 0; llama4
   with ``rescale_qk``; the plain run of an MoE model is given the
   kernels' run's expert choices); logits at every step
   against the same run on the plain versions (held, except the
   hybrid's: reported), the decode kernel's
   launches = steps x self-attention layers, flash's = the prompt's
   attention layers (0 for mamba2; seamless: 12 encoder + 12 decoder
   self + 12 cross) + steps x cross-attention layers (seamless's 12),
   the time of ``api.prefill`` (host clock around a synchronised call,
   median of 3) and the time per decode step; then the served MoE
   block's grouped expert product (``moe_grouped_phase``): its two CUDA
   kernels against their plain version at Qwen3-30B-A3B's widths (bf16
   within 1e-2 of the output's size, fp32 within 1e-4), timed beside
   their bound, the plain loop, the padded path's bmm and torch's
   ``_grouped_mm``, no spill; and Qwen3-30B-A3B (the benchmark's
   configuration) cut to 4 layers at full width, served at B2 S2048:
   every segment's replay bit for bit with its eager run, the kernels'
   launches exactly two a layer a call;
7. serving: ``serve_pair`` hosts qwen3-4b (Q0) with stablelm-1.6b, with
   recurrentgemma-9b (pair E of the paper's Fig 16), with mamba2-2.7b
   (pair A) and with granite-20b (pair B); stablelm-1.6b (Q0) with
   h2o-danube-3-4b (pair F); seamless-m4t-medium (Q0) with
   llava-next-mistral-7b (pair J); llama4-scout-17b-a16e-L8 (Q0) with
   qwen3-4b (pair H) and deepseek-v2-236b-L6 (Q0) with mamba2-2.7b
   (pair D); at full size under FIKIT and under
   SHARING, each system released before the next; every kernel's launch
   counter is set to 0 before each run and read after it, and flash must
   show exactly every attention layer of the run's invocations, and its
   launches with Sq != Sk exactly their cross-attention layers (flash
   counts its launches per shape, so each entry of the ``kernels`` line
   gives the launches at its own shape); a segment replayed from its CUDA
   graph runs no wrapper, so its launches are the ones its graph's
   capture counted, booked once a replay (``kernels._launches``): the
   counts are those of the eager path;
8. profile: the measurement phase's SK/SG per segment of each service at
   full size, beside one layer's (or block's) device time (seamless: its
   whole encode segment and one decoder layer); then every segment of
   both services replayed from its CUDA graph against its body run
   eagerly on the same input, chained, bit for bit (``replay_check``);
9. load: ``serve_load`` of pair A at full size, open-loop Poisson gold
   (qwen3-4b B1 S32, Q0, a 0.5 s deadline) and diurnal bronze (mamba2-2.7b
   B2 S32, Q5) through the admission plane, at 0.5x and 2x the capacity
   the measurement phase gives under FIKIT and at 0.5x under SHARING;
   per class offered, admitted, completed, rejected, shed, p50/p99 and
   goodput; fails on a FAILED ticket, a priority inversion, a class that
   breaks the plane's invariant, or a flash count other than 36 per
   qwen3 invocation the engine ran (the ``admit`` events count them);
10. ops: pair A's ``serve_pair`` without and with a jobstore (hi JCT,
   qwen3's sharing-phase layer SK/SG, each write-ahead record's time);
   one full-width qwen3-4b service paused and resumed through control
   rows the poller consumes (tokens equal to an uninterrupted run's) and
   cancelled mid-flight (its device memory comes back); a RUNNING row
   recovered to DONE by ``serve_pair(..., resume=True)``; the ``status``
   verb, run as a subprocess, lists every job DONE or CANCELLED;
11. mesh: the ``make_*_step`` functions under the (1, 1) ("data",
   "model") host mesh (``make_host_mesh()``: a world-1 NCCL group,
   destroyed at the phase's end), parameters, optimizer state, batches
   and caches ``DTensor``s:
   (b) full-width qwen3-4b cut to 2 layers, B2 S2048: the meshed loss and
   every gradient (``steps.loss_and_grads``) against the un-meshed ones,
   and one meshed ``make_train_step`` step against the un-meshed step
   (loss, grad norm, every parameter after the update), bit for bit, or,
   where one is not, each within MESH_TOL of its norm with the tensors
   named (a gradient may differ only where two un-meshed runs differ:
   the embedding lookup's backward accumulates in the threads' order);
   flash's forward (twice a layer under remat) and backward
   launches exact; (c) full-width qwen3-4b, meshed ``make_prefill_step``
   (B2, prompt 1024) and 16 meshed ``make_serve_step``s against phase 6's
   ``generate`` run again on the same weights and tokens, logits bit for
   bit at every step, decode launches exactly 16 x 36 and flash's 36, the
   decode step's host time both ways; (d) full-width
   llama4-scout-17b-a16e-L4, meshed prefill of phase 6's 8320-token
   prompt: the (1, 1) mesh takes the MoE block's single-device branch
   (ep = 1: asserted), logits bit for bit with the un-meshed prefill's;
   (e) the meshed full-depth qwen3-4b ``make_train_step`` on phase 4
   (b)'s weights, shape and batches, timed as phase 4 (b)'s un-meshed
   ``train()`` is: its losses bit for bit with phase 4 (b)'s (within
   MESH_TOL where (b) found the un-meshed gradients not repeatable),
   flash's launches exact, time per step, tokens/s and peak memory
   beside phase 4 (b)'s, in this process.

Every path (each train step check and the train run, generate, each
serving, load and ops run) is driven with all launch counters set to 0
just before it and read just after; launches made to
compare a kernel with its plain version are not counted. The
second-to-last lines are a JSON object of the kernels and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
PEAK = {"float32": 67e12, "bfloat16": 989e12}   # fp32 CUDA cores; bf16 TC
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 flash, per element, over the plain output's size: two bf16 ulps
# (a long row's outputs are about its length ** -0.5, far under 2e-2)
SCALED_TOL = 2 ** -6
# the fields of a kernel's plan that a case's line shows (decode's split
# plan, rglru_scan's scan plan, flash backward's launch plan)
PLAN_SHOWN = ("splits", "split_len", "tw", "nseg", "threads", "blocks",
              "ctas", "stages", "smem_bytes", "partial_bytes", "warpgroups",
              "dq_warpgroups", "dq_ctas", "head_split", "kv_ctas")
RGLRU_TOL = 1e-4
HI, LO, HYB = "qwen3-4b", "stablelm-1.6b", "recurrentgemma-9b"
SSM_LO, GRANITE = "mamba2-2.7b", "granite-20b"    # pairs A and B
LOW_SERVICES = (LO, HYB, SSM_LO, GRANITE)
REQUESTS, MEASURE_RUNS = 4, 3
GEN_STEPS = 16
# the generate phase's (model, batch, prompt): past the hybrid's 2048
# window; mamba2's prompt a multiple of its 256-token SSD chunk
GENERATE = ((HYB, 2, 2100), (HI, 2, 1024), (SSM_LO, 2, 2048))
# h2o-danube-3-4b (dense, head dim 120: pair F's low service), and
# seamless-m4t-medium (encoder-decoder) and llava-next-mistral-7b (VLM),
# pair J's high and low services
H2O, SEAMLESS, LLAVA = ("h2o-danube-3-4b", "seamless-m4t-medium",
                        "llava-next-mistral-7b")
# the serving phase's (high Q0, low Q5) pairs: qwen3-4b over each earlier
# low service, then pairs F and J of the paper's Fig 16
PAIRS = tuple((HI, low) for low in LOW_SERVICES) + ((LO, H2O),
                                                     (SEAMLESS, LLAVA))
# the generate phase's (model, batch, text tokens) for these: h2o past
# its 4096 window (a wrapped D 120 ring), seamless over its 1024 frames,
# llava after its 2880 patches
GENERATE_NEW = ((H2O, 2, 4160), (SEAMLESS, 2, 64), (LLAVA, 2, 64))
KERNELS = ("flash_attention", "decode_attention", "rglru_scan")
# the load phase: serve_load's classes (gold Q0 with a 0.5 s deadline,
# bronze Q5 with none), 30 % of the offered requests gold, bronze
# diurnal; (mode, factor of the capacity, seconds of arrivals)
LOAD_SHARE, LOAD_DEADLINE, LOAD_SEED = 0.3, 0.5, 0
LOAD_RUNS = (("fikit", 0.5, 8.0), ("fikit", 2.0, 4.0), ("sharing", 0.5, 8.0))
# the ops phase: the store, and the segment an invocation is held at
# (embed and four layers done) before it is paused or cancelled
OPS_DB = os.path.join(ROOT, "build", "ops_smoke.db")
OPS_AT = 5

# flash_attention: B, H, Kh, Sq, Sk, D, kwargs
TEST_CASES = [                        # tests/test_kernels.py's shapes
    (2, 4, 4, 256, 256, 64, {}),
    (1, 8, 2, 256, 256, 128, dict(window=96)),
    (2, 4, 1, 384, 384, 64, dict(chunk=128)),
    (1, 2, 2, 128, 512, 64, dict(causal=False)),
    (1, 4, 4, 512, 512, 96, dict(window=128)),
]
HI_SHAPE = (2, 32, 8, 48, 48, 128, {})      # qwen3-4b at batch 2, seq 48
LO_SHAPE = (4, 32, 32, 48, 48, 64, {})      # stablelm-1.6b at batch 4
HYB_SHAPE = (4, 16, 1, 48, 48, 256, dict(window=2048))   # hybrid serving
GRANITE_SHAPE = (4, 48, 1, 48, 48, 128, {})  # granite-20b: MQA, G 48
HYB_PROMPT = (2, 16, 1, 2100, 2100, 256, dict(window=2048))
HI_PROMPT = (2, 32, 8, 1024, 1024, 128, {})  # qwen3-4b prefill, prompt 1024
RAGGED = (2, 4, 2, 48, 48, 64, dict(window=16))
ALL_MASKED = (1, 4, 2, 40, 72, 64, dict(window=0))
LONG = (1, 32, 8, 4096, 4096, 128, {})
# this slice's paths: h2o-danube-3-4b's head dim 120 serving (B4) and its
# 4160-token prompt past the 4096 window; seamless-m4t-medium's
# non-causal cross-attention of 48 decoder rows (serving) and of one (a
# decode step) over 1024 frames, and its encoder; llava-next's 2881-token
# sequence (2880 patches + 1 token, off every tile grid) when serving
H2O_SHAPE = (4, 32, 8, 48, 48, 120, dict(window=4096))
H2O_PROMPT = (2, 32, 8, 4160, 4160, 120, dict(window=4096))
CROSS_48 = (2, 16, 16, 48, 1024, 64, dict(causal=False))
CROSS_1 = (2, 16, 16, 1, 1024, 64, dict(causal=False))
ENCODER = (2, 16, 16, 1024, 1024, 64, dict(causal=False))
LLAVA_SHAPE = (4, 32, 8, 2881, 2881, 128, dict(window=4096))
# the same work at head dim 128, beside the D 120 instance
D128_AT_H2O = [case[:5] + (128, case[6]) for case in (H2O_SHAPE, H2O_PROMPT)]
# the bf16 kernel's tiling edges (tests/test_torch_flash_attention.py):
# Sq, Sk off the tile grid with Sk != Sq; window and chunk borders inside
# a kv tile; D 96 past 128 rows; two warpgroups a CTA, one past Sq
EDGE_CASES = [
    (1, 4, 2, 100, 150, 64, dict(causal=False)),
    (2, 8, 2, 130, 77, 128, dict(causal=False)),
    (1, 4, 4, 256, 256, 64, dict(window=40)),
    (1, 4, 2, 320, 320, 128, dict(chunk=96)),
    (1, 4, 2, 200, 200, 96, {}),
    (1, 32, 8, 640, 640, 128, {}),
    (1, 32, 8, 530, 530, 64, dict(window=100)),
]

# decode_attention: B, H, Kh, C, D, kwargs, pos (kpos 0..C-1, or a
# wrapped ring when pos >= C; RING_CASE has empty slots)
DECODE_CASES = [                      # tests/test_kernels.py's shapes
    (2, 8, 2, 512, 64, {}, 300),
    (1, 4, 1, 1024, 128, dict(window=256), 900),
    (2, 4, 4, 512, 64, dict(chunk=256), 400),
    (3, 8, 8, 256, 128, {}, 100),
]
RING_CASE = (1, 4, 2, 256, 64, dict(window=64), 99)
DEC_HI = (2, 32, 8, 1040, 128, {}, 1039)    # qwen3-4b, generate phase
DEC_HYB = (2, 16, 1, 2048, 256, dict(window=2048), 2115)   # wrapped ring
DEC_MASKED = (1, 4, 2, 96, 64, dict(window=0), 50)
# h2o-danube-3-4b's wrapped 4096-slot D 120 ring at the generate phase's
# last step, and the same at D 128; seamless's self-attention (64 + 16
# slots, G 1) and llava's (2880 + 64 + 16 slots)
DEC_H2O = (2, 32, 8, 4096, 120, dict(window=4096), 4175)
DEC_H2O_D128 = DEC_H2O[:4] + (128,) + DEC_H2O[5:]
DEC_SEAMLESS = (2, 16, 16, 80, 64, {}, 79)
DEC_LLAVA = (2, 32, 8, 2960, 128, dict(window=4096), 2959)
DEC_LONG = (1, 32, 8, 32768, 128, {}, 32767)
# the bf16 kernel's edges (tests/test_torch_decode_attention.py): G 1, 16,
# 32 and 64 (one to four m16 head tiles); C 1000, off the 16-slot tile;
# window and chunk borders inside a tile; splits all masked beside a
# valid one; every slot masked over many splits (mean(v))
DEC_EDGE = [
    (1, 32, 32, 1000, 64, {}, 990),
    (2, 16, 1, 1000, 128, dict(window=300), 999),
    (1, 32, 1, 1040, 128, {}, 1030),
    (1, 64, 1, 2048, 256, dict(window=2048), 2115),
    (1, 8, 2, 512, 128, dict(window=37), 300),
    (1, 8, 2, 512, 64, dict(chunk=40), 300),
    (2, 32, 8, 1040, 128, dict(window=20), 1030),
    (1, 16, 1, 1000, 256, dict(window=0), 500),
]

# rglru_scan: B, S, W, with h0
RGLRU_CASES = [(8, 256, 256), (4, 128, 512), (16, 512, 128), (8, 384, 384)]
RG_SERVE = (4, 48, 4096)              # recurrentgemma-9b serving, fp32
RG_PREFILL = (2, 2100, 4096)          # the generate phase's prompt
RG_LONG = (1, 8192, 4096)             # B 1: 32-column tiles underfill
# the scan's edges (tests/test_torch_rglru_scan.py): S = 1; S one short of
# and one past one and two of the prompt plan's 96-row blocks; W off the
# 32- and the 16-column tile
RG_EDGE = [(4, 1, 4096), (2, 95, 4096), (2, 97, 4096), (2, 191, 4096),
           (2, 193, 4096), (2, 300, 4100), (3, 129, 1001)]

# the backward kernels (the train path): their sources, built with the
# forward kernels', and the tolerance of each gradient, on the scaled
# error |kernel - plain| / (|plain| + rms of the plain gradient): fp32
# 1e-4, bf16 2e-2 (flash; rglru_scan's error over max(1, max|plain|))
BWD_SOURCES = ("flash_attention_bwd", "rglru_scan_bwd")
# the grouped expert product of the served MoE block
MOE_SOURCES = ("moe_grouped_gemm",)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# what a backward replaces: the JAX package differentiates its jnp paths
# with XLA, and no Pallas kernel has a backward
FLASH_BWD_REPLACES = ("jax.grad of src/repro/models/attention.py:80 "
                      "(attend; XLA autodiff)")
RGLRU_BWD_REPLACES = ("jax.grad of src/repro/models/rglru.py:115 "
                      "(rglru_scan_full; XLA autodiff)")
# flash backward: the test shapes, ragged S (a window inside a tile; Sq
# != Sk causal), GQA and MQA (in the test shapes), non-causal
# cross-attention Sq 48 / Sk 1024, all-masked rows, D 120, and the train
# shapes: qwen3-4b's layer (B2 S2048) and the hybrid's attention block
# (MQA, D 256, its 2048 window crossed at S 2100)
QWEN_TRAIN = (2, 32, 8, 2048, 2048, 128, {})
HYB_TRAIN = (2, 16, 1, 2100, 2100, 256, dict(window=2048))
FLASH_BWD_CASES = TEST_CASES + [
    RAGGED, (2, 8, 2, 130, 77, 128, {}), CROSS_48, ALL_MASKED,
    (1, 8, 2, 256, 256, 120, dict(window=96)), QWEN_TRAIN, HYB_TRAIN]
# rglru_scan backward: test shapes, ragged, S = 1, S one short of and one
# past one and two of the fp32 backward plan's 64-row blocks, W off the
# 32-column tile, and the hybrid's train shape [2, 2100, 4096], each with
# and without h0
RG_TRAIN = (2, 2100, 4096)
RG_BWD_CASES = RGLRU_CASES[:2] + [
    (3, 37, 200), (4, 1, 4096), (2, 63, 4096), (2, 65, 4096),
    (2, 127, 4096), (2, 129, 4096), (2, 300, 4100), RG_TRAIN]
# the train phase: (a) qwen3-4b at full width cut to 2 layers and (c)
# recurrentgemma-9b at full width cut to one (rec, rec, attn) pattern,
# one step's gradients through the kernels against the plain versions,
# each tensor's within TRAIN_GRAD_TOL of its norm (bf16 weights: both
# runs round every activation to bf16; the kernels' forward rounds P to
# bf16 for wgmma); (b) full-width, full-depth qwen3-4b, TRAIN_STEPS
# steps of the synthetic pipeline through ``launch.train.train``
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 4
HYB_TRAIN_S = 2100
TRAIN_GRAD_TOL = 5e-2

# the MoE family at full width, cut in depth to fit one card (registered
# under these names by ``register_moe_cuts``): llama4-scout-17b-a16e
# (48 layers) to two chunk-pattern groups of 4 (3 chunked + 1 full; 39.3
# GB of bf16 weights) beside pair H's qwen3-4b, and to one group (19.6
# GB) in the generate phase, where the plain flash at its 8320-token
# prompt needs about 45 GB; deepseek-v2-236b (60 layers, MLA) to 6
# (49.7 GB) beside pair D's mamba2-2.7b
LLAMA4, DEEPSEEK = "llama4-scout-17b-a16e", "deepseek-v2-236b"
MOE_CUTS = {f"{LLAMA4}-L8": (LLAMA4, 8), f"{LLAMA4}-L4": (LLAMA4, 4),
            f"{DEEPSEEK}-L6": (DEEPSEEK, 6)}
LLAMA4_L8, LLAMA4_L4, DEEPSEEK_L6 = MOE_CUTS
# pairs H and D of the paper's Fig 16: an MoE model as the high service
MOE_PAIRS = ((LLAMA4_L8, HI), (DEEPSEEK_L6, SSM_LO))
# the grouped expert product's cases (T, skewed routing, dtype) at
# Qwen3-30B-A3B's widths, and its service cut to QWEN3_MOE_LAYERS layers
MOE_GEMM_CASES = ((512, False, "bfloat16"), (512, False, "float32"),
                  (4096, False, "bfloat16"), (4096, True, "bfloat16"))
QWEN3_MOE_FILE = os.path.join(ROOT, "servebench", "configs",
                              "qwen3-4b.qwen3-30b-a3b.json")
QWEN3_MOE_LAYERS = 4
# the generate phase's (model, batch, prompt, rescale_qk): llama4 past its
# 8192 chunk (its chunked and full layers' rings both wrap), with wq and
# wk at fan_in d_model as h2o's, seamless's and llava's (``rescale_qk``:
# at the reference init, with 40 heads and no qk-norm, the prefill's last
# logits moved by 46 % of their size between the kernels and the plain
# versions on an H100); deepseek (MLA, no kernel: the two runs are one
# function) at a multiple of MLA's 512-row block
MOE_GENERATE = ((LLAMA4_L4, 1, 8320, True), (DEEPSEEK_L6, 2, 1024, False))
# deepseek's two forms (phase 5): forward over MOE_FORMS_S tokens against
# prefill of the first S - 1 and one decode step. Each form sizes an
# expert's capacity from its own token count, so an entry dropped in one
# would differ by design: at B1 S8 no entry can be dropped (a token takes
# an expert once, and C is at least 8 or every entry), which the check
# asserts; at S16 the random full-width model dropped one. The last
# position's logits of the two forms differ by 6.6e-3 of max|logit| on an
# H100 (bf16 over 6 layers, the same expert choices); held to 3x that
MOE_FORMS_B, MOE_FORMS_S = 1, 8
MOE_FORMS_TOL = 2e-2
# deepseek's MLA sublayer alone (no MoE, so no capacity to differ) at the
# generate phase's shape: prefill of a B2 1024-token prompt (two 512-row
# q blocks) into a 1040-slot cache and 16 decode steps, against the full
# form over the same 1040 rows (three q blocks); each form's max |diff|
# over max |full|. Both forms gave the full form's bits on an H100 (0.0);
# held to one bf16 step at max |full| (2^-8)
MLA_FORMS_B, MLA_FORMS_PROMPT, MLA_FORMS_STEPS = 2, 1024, 16
MLA_FORMS_TOL = 2.0 ** -8
# llama4's kernel shapes: serving (B2 S48; its chunked and its full
# layers), the generate phase's 8320-token prompt (the chunk border
# inside a tile) and last step's 8192-slot wrapped ring (chunked layers:
# the 144 slots of the second chunk valid; full layers: all), and the
# train shape of phase 4 (d); G 5 (40 query heads over 8 kv heads)
L4_SERVE = (2, 40, 8, 48, 48, 128, dict(chunk=8192))
L4_SERVE_FULL = (2, 40, 8, 48, 48, 128, {})
L4_PROMPT = (1, 40, 8, 8320, 8320, 128, dict(chunk=8192))
L4_PROMPT_FULL = (1, 40, 8, 8320, 8320, 128, {})
DEC_L4 = (1, 40, 8, 8192, 128, dict(chunk=8192), 8335)
DEC_L4_FULL = (1, 40, 8, 8192, 128, {}, 8335)
L4_TRAIN = (2, 40, 8, 2048, 2048, 128, dict(chunk=8192))
# bwd_plan splits a kv head's query heads only below one wave of key
# tiles (groups < SMS): L4_TRAIN's 256 groups take no split; at B1 S1024
# (64 groups) the five heads of a group split five ways, the first odd
# split the kernel meets
L4_SPLIT5 = (1, 40, 8, 1024, 1024, 128, {})


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase header ([...]) carries the seconds since
    the start."""
    if msg.startswith("["):
        msg = f"{msg} (+{time.perf_counter() - _T0:.0f} s)"
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def device_ms(torch, fn, n: int, reps: int = 5) -> float:
    """Median device time of one call of ``fn``: n calls back to back
    between CUDA events, queued behind a sleep kernel so that the card
    does not wait for the host. When the host's enqueue took more than
    half the sleep, the window is taken again with a sleep twice as long,
    at most three times per window (a ``fn`` that waits on the card, or
    that fills the card's launch queue, never gets ahead of it; its last
    window is kept, an upper bound)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        cycles = 20_000_000
        for _attempt in range(4):
            head, start, end = (torch.cuda.Event(enable_timing=True)
                                for _ in range(3))
            head.record()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            end.record()
            end.synchronize()
            if host_ms <= 0.5 * head.elapsed_time(start):
                break
            cycles *= 2
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def least_ms(nbytes: float, ops: float, dtype: str):
    """The least time (ms) the card could take: bytes over HBM bandwidth
    against operations over the peak rate of the type; and which bounds
    it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def finish_case(torch, label, out, want, tol, kernel_fn, plain_fn, lib_fn,
                n, bound, extra, plain_n=None):
    """Hold the kernel's output against the plain version's, then time
    the kernel (n calls a window), the plain version (``plain_n``) and the
    library call."""
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    if not (err < tol) or out.dtype != want.dtype or out.shape != want.shape:
        raise AssertionError(f"{label}: max|kernel - plain| = {err} "
                             f"(tol {tol})")
    return timed_case(torch, label, err, kernel_fn, plain_fn, lib_fn, n,
                      bound, extra, plain_n)


def timed_case(torch, label, err, kernel_fn, plain_fn, lib_fn, n, bound,
               extra, plain_n=None):
    """The record of a case whose error ``err`` was held: the kernel's
    median time (n calls a window), the plain version's (``plain_n``) and
    the library call's, beside the bound."""
    ms = device_ms(torch, kernel_fn, n)
    plain_ms = device_ms(torch, plain_fn, plain_n or max(1, n // 4))
    library_ms = None if lib_fn is None else device_ms(torch, lib_fn, n)
    bound_ms, bound_by = bound
    rec = dict(extra, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    if "scaled_err" in extra:
        err = f"{err:.3g} (scaled {extra['scaled_err']:.3g})"
    elif "grad_errs" in extra:
        err = f"{err:.3g} (scaled {max(extra['grad_errs']):.3g})"
    else:
        err = f"{err:.3g}"
    plan = ""
    if "plan" in extra:
        plan = " | plan " + ", ".join(
            f"{k} {v}" for k, v in extra["plan"].items() if k in PLAN_SHOWN)
    log(f"  {label}: err {err} | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib}, bound {bound_ms:.5f} ms "
        f"({bound_by}){plan}")
    return rec


# ------------------------------------------------------------ flash cases
def scaled_err(torch, out, want) -> float:
    """max |out - want| / (|want| + rms of want's row over D): the error
    against the size of the output, which an absolute bound misses where
    rows are long and their outputs small."""
    out, want = out.float(), want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    return float(((out - want).abs() / (want.abs() + rms)).max())


def allowed_pairs(torch, Sq, Sk, causal=True, window=None, chunk=None):
    """(q, k) pairs the mask keeps: the work this run's data needs."""
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    if chunk is not None:
        mask &= (qpos // chunk) == (kpos // chunk)
    return mask, int(mask.sum())


def check_flash_case(torch, K, case, dtype, seed, path_layout=False):
    """flash_attention vs its plain version on the card; ``path_layout``:
    q, k, v as ``attend`` hands them over, transposed views of
    [B, S, heads, D] projections."""
    import torch.nn.functional as F
    ops, ref = K["flash_attention"]
    B, H, Kh, Sq, Sk, D, kw = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    if path_layout:
        q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda")
                   .to(dtype).transpose(1, 2)
                   for S, n in ((Sq, H), (Sk, Kh), (Sk, Kh)))
    else:
        q = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Kh, Sk, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Kh, Sk, D, generator=g, device="cuda").to(dtype)
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    name = dtype_name(dtype)
    layout = "BSHD views" if path_layout else "BHSD"
    label = f"flash_attention {case[:6]} {kw} {name} {layout}"
    extra = {"shape": list(case[:6]), "kw": kw, "dtype": name,
             "layout": layout}
    if dtype == torch.bfloat16:
        # the forward's launch plan: 64-row warpgroups a CTA, CTAs
        from repro_torch.kernels.flash_attention.kernel import warpgroups
        wg = warpgroups(B, H, Sq)
        extra["plan"] = {"warpgroups": wg,
                         "ctas": B * H * -(-Sq // (64 * wg))}
        extra["scaled_err"] = scaled_err(torch, out, want)
        if not extra["scaled_err"] < SCALED_TOL:
            raise AssertionError(f"{label}: max|kernel - plain| / (|plain| "
                                 f"+ row rms) = {extra['scaled_err']} (tol "
                                 f"{SCALED_TOL})")
    # yardstick only: PyTorch's fused attention on the same inputs (kv
    # heads expanded and the mask built outside the timed call)
    G = H // Kh
    ke, ve = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    mask, pairs = allowed_pairs(torch, Sq, Sk, **kw)
    if kw or Sq != Sk:
        mask = mask.cuda()
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, ke, ve, attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, ke, ve, is_causal=True)
    esz = 2 if dtype == torch.bfloat16 else 4
    bound = least_ms(esz * D * (2 * B * H * Sq + 2 * B * Kh * Sk),
                     4 * D * B * H * pairs, name)
    return finish_case(
        torch, label, out, want, TOL[name],
        lambda: ops.flash_attention(q, k, v, **kw),
        lambda: ref.flash_attention_ref(q, k, v, **kw), lib,
        5 if Sq >= 2048 else 20, bound, extra)


# ----------------------------------------------------------- decode cases
def ring_kpos(torch, C, pos, empty_from=None):
    """Slot positions of a cache: 0..C-1 below C, a wrapped ring (slot i
    holds the position p with p % C == i) past it; slots from
    ``empty_from`` on are empty (-1)."""
    if pos < C:
        kp = torch.arange(C, dtype=torch.int32)
    else:
        p = torch.arange(pos + 1 - C, pos + 1, dtype=torch.int32)
        kp = p[torch.argsort(p % C)]
    if empty_from is not None:
        kp[empty_from:] = -1
    return kp.cuda()


def check_decode_case(torch, K, case, dtype, seed, empty_from=None):
    """decode_attention vs its plain version on the card; k and v are the
    model's [B, C, Kh, D] cache, handed over as [B, Kh, C, D] views."""
    import torch.nn.functional as F
    ops, ref = K["decode_attention"]
    B, H, Kh, C, D, kw, pos = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    kc = torch.randn(B, C, Kh, D, generator=g, device="cuda").to(dtype)
    vc = torch.randn(B, C, Kh, D, generator=g, device="cuda").to(dtype)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    kpos = ring_kpos(torch, C, pos, empty_from)
    out = ops.decode_attention(q, k, v, kpos, pos, **kw)
    want = ref.decode_attention_ref(q, k, v, kpos, pos, **kw)
    valid = ref.slot_mask(kpos, pos, kw.get("window"), kw.get("chunk"))
    name = dtype_name(dtype)
    label = f"decode_attention {case[:5]} {kw} pos {pos} {name}"
    extra = {"shape": list(case[:5]), "kw": kw, "pos": pos, "dtype": name,
             "valid_slots": int(valid.sum())}
    if dtype == torch.bfloat16:
        extra["plan"] = decode_plan(torch, B, H, Kh, C, D)
        extra["scaled_err"] = scaled_err(torch, out, want)
        if not extra["scaled_err"] < SCALED_TOL:
            raise AssertionError(f"{label}: max|kernel - plain| / (|plain| "
                                 f"+ row rms) = {extra['scaled_err']} (tol "
                                 f"{SCALED_TOL})")
    if not bool(valid.any()):                  # every slot masked: mean(v)
        mean_v = v.float().mean(2).repeat_interleave(H // Kh, 1)
        err = float((out.float() - mean_v).abs().max())
        if not err < TOL[name]:
            raise AssertionError(f"{label}: all masked, max|kernel - "
                                 f"mean(v)| = {err}")
    # yardstick only: SDPA with a boolean mask, kv expanded outside the
    # timed call
    G = H // Kh
    ke = k.repeat_interleave(G, 1).contiguous()
    ve = v.repeat_interleave(G, 1).contiguous()
    q4, m4 = q[:, :, None], valid[None, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, ke, ve, attn_mask=m4)
    # the bytes the function needs: q and out, the K/V rows of the valid
    # slots only (a masked slot's row need not be read) and kpos
    esz = 2 if dtype == torch.bfloat16 else 4
    bound = least_ms(esz * (2 * B * H * D
                            + 2 * B * Kh * extra["valid_slots"] * D) + 4 * C,
                     4 * D * B * H * extra["valid_slots"], name)
    return finish_case(
        torch, label, out, want, TOL[name],
        lambda: ops.decode_attention(q, k, v, kpos, pos, **kw),
        lambda: ref.decode_attention_ref(q, k, v, kpos, pos, **kw), lib,
        5 if C >= 8192 else 20, bound, extra)


def decode_plan(torch, B, H, Kh, C, D) -> dict:
    """The bf16 decode kernel's split plan for this shape on this card,
    its shared memory held to the library's own layout."""
    from repro_torch.kernels.decode_attention import kernel
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = kernel.split_plan(B * Kh, H // Kh, C, D, sms)._asdict()
    lib_smem = kernel.library().decode_attention_smem_bytes(1, D, H // Kh)
    if lib_smem != plan["smem_bytes"]:
        raise AssertionError(f"decode plan's shared memory {plan} differs "
                             f"from the kernel's {lib_smem} bytes")
    return plan


# ------------------------------------------------------------ rglru cases
def rglru_inputs(torch, case, dtype, seed, with_h0=True):
    """a in [0.3, 0.999), b of scale 0.1 and an fp32 h0 (or None), drawn
    on the card from ``seed``."""
    B, S, W = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = (0.3 + 0.699 * torch.rand(B, S, W, generator=g, device="cuda")
         ).to(dtype)
    b = (0.1 * torch.randn(B, S, W, generator=g, device="cuda")).to(dtype)
    h0 = (torch.randn(B, W, generator=g, device="cuda") if with_h0
          else None)
    return a, b, h0


def check_rglru_case(torch, K, case, dtype, seed, with_h0=True):
    """rglru_scan vs its plain version on the card. No single PyTorch
    call computes a linear recurrence, so there is no library time."""
    ops, ref = K["rglru_scan"]
    B, S, W = case
    a, b, h0 = rglru_inputs(torch, case, dtype, seed, with_h0)
    out = ops.rglru_scan(a, b, h0)
    want = ref.rglru_scan_ref(a, b, h0)
    name = dtype_name(dtype)
    plan = rglru_plan(torch, B, S, W, dtype)
    esz = 2 if dtype == torch.bfloat16 else 4
    bound = least_ms(3 * esz * B * S * W + (4 * B * W if with_h0 else 0),
                     2 * B * S * W, "float32")
    tol = RGLRU_TOL if dtype == torch.float32 else TOL[name]
    # the plain loop is 3 launches per step: time it a call at a time
    return finish_case(
        torch, f"rglru_scan {case} h0={with_h0} {name}", out, want, tol,
        lambda: ops.rglru_scan(a, b, h0),
        lambda: ref.rglru_scan_ref(a, b, h0), None,
        20 if S <= 512 else 4, bound,
        {"shape": list(case), "h0": with_h0, "dtype": name, "plan": plan},
        plain_n=1)


def rglru_plan(torch, B, S, W, dtype) -> dict:
    """The scan's plan for this shape on this card, its rows a thread
    holds held to the library's own."""
    from repro_torch.kernels.rglru_scan import kernel
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib_rows = kernel.library().rglru_scan_rows()
    if lib_rows != kernel.ROWS:
        raise AssertionError(f"rglru plan's {kernel.ROWS} rows a thread "
                             f"differ from the kernel's {lib_rows}")
    return kernel.scan_plan(B, S, W, dtype, sms)._asdict()


# ------------------------------------------------------- backward cases
def grad_err(torch, got, want) -> float:
    """max |got - want| / (|want| + rms of want): a gradient's error
    against its size (a row can be exactly zero, so not the row's rms);
    a gradient that is zero everywhere must be zero."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt().clamp_min(torch.finfo().tiny)
    return float(((got - want).abs() / (want.abs() + rms)).max())


def check_flash_bwd_case(torch, K, case, dtype, seed):
    """flash_attention's backward kernel, reached through autograd on
    attend's transposed [B, S, heads, D] views, against autograd of the
    plain version: in fp32 on the same inputs (bf16 upcast), its
    gradients rounded once to the input type (autograd of the bf16 call
    would round each query head's dk and dv before summing the group).
    The kernels counted must be the library's and the plan's for the
    dtype; at the bf16 train shapes a second call must give bitwise-equal
    gradients. Times the backward kernel alone, the plain version's
    backward and SDPA's backward (kv heads expanded outside; a yardstick
    only)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_PASSES, DTYPES, bwd_library, bwd_plan,
        flash_attention_bwd_kernel)
    need = BWD_PASSES[dtype]
    lib_passes = bwd_library().flash_attention_bwd_passes(DTYPES[dtype])
    if lib_passes != need:
        raise AssertionError(f"the binding counts {need} backward kernels "
                             f"a call in {dtype}; the library launches "
                             f"{lib_passes}")
    ops, ref = K["flash_attention"]
    B, H, Kh, Sq, Sk, D, kw = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda")
               .to(dtype).transpose(1, 2)
               for S, n in ((Sq, H), (Sk, Kh), (Sk, Kh)))
    dout = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dtype)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = K["launchers"]["flash_attention"].bwd_launches
    out = ops.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    passes = K["launchers"]["flash_attention"].bwd_launches - before
    bitwise = None
    if dtype == torch.bfloat16 and case in (QWEN_TRAIN, HYB_TRAIN, L4_TRAIN,
                                            L4_SPLIT5):
        again = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                    leaves, dout)
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        if not bitwise:
            raise AssertionError(f"flash_attention backward {case[:6]} "
                                 f"bf16: two calls gave different "
                                 f"gradients")
    f32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*f32, **kw), f32,
                               dout.float())
    name = dtype_name(dtype)
    label = f"flash_attention backward {case[:6]} {kw} {name} BSHD views"
    errs = [grad_err(torch, got, w.to(dtype))
            for got, w in zip(grads, want)]
    if passes != need or any(
            got.dtype != dtype or got.shape != t.shape
            for got, t in zip(grads, (q, k, v))):
        raise AssertionError(f"{label}: {passes} backward kernels (need "
                             f"{need}) or gradients of the wrong "
                             f"type or shape")
    if not max(errs) < BWD_TOL[name]:
        raise AssertionError(f"{label}: scaled error of dq, dk, dv {errs} "
                             f"(tol {BWD_TOL[name]})")
    abs_err = max(float((got.float() - w.to(dtype).float()).abs().max())
                  for got, w in zip(grads, want))
    del want, f32
    # the plain version's backward on the same inputs, and SDPA's
    plain_in = [t.detach().requires_grad_(True) for t in (q, k, v)]
    plain_out = ref.flash_attention_ref(*plain_in, **kw)
    G = H // Kh
    lib_in = [t.detach().requires_grad_(True) for t in
              (q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1))]
    mask, pairs = allowed_pairs(torch, Sq, Sk, **kw)
    if kw or Sq != Sk:
        lib_out = F.scaled_dot_product_attention(*lib_in,
                                                 attn_mask=mask.cuda())
    else:
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True)
    esz = 2 if dtype == torch.bfloat16 else 4
    bound = least_ms(esz * D * (3 * B * H * Sq + 4 * B * Kh * Sk),
                     10 * D * B * H * pairs, name)
    rec = timed_case(
        torch, label, abs_err,
        lambda: flash_attention_bwd_kernel(q, k, v, dout, **kw),
        lambda: torch.autograd.grad(plain_out, plain_in, dout,
                                    retain_graph=True),
        lambda: torch.autograd.grad(lib_out, lib_in, dout,
                                    retain_graph=True),
        10, bound,
        {"shape": list(case[:6]), "kw": kw, "dtype": name,
         "layout": "BSHD views", "grad_errs": errs, "passes": passes,
         "bitwise_repeat": bitwise,
         "plan": bwd_plan(B, H, Kh, Sq, Sk, D, dtype)._asdict()},
        plain_n=1)
    del plain_out, lib_out
    return rec


def check_rglru_bwd_case(torch, K, case, dtype, seed, with_h0=True):
    """rglru_scan's backward kernel through autograd against autograd of
    the plain version on the same inputs: each gradient within BWD_TOL of
    max(1, its largest value), exactly one backward launch; at RG_TRAIN a
    second call must give bitwise-equal gradients. Prints the backward's
    plan. No single PyTorch call computes the recurrence, so there is no
    library time."""
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd_kernel
    ops, ref = K["rglru_scan"]
    B, S, W = case
    a, b, h0 = rglru_inputs(torch, case, dtype, seed, with_h0)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(B, S, W, generator=g, device="cuda").to(dtype)
    leaves = [t.requires_grad_(True) for t in (a, b, h0) if t is not None]
    before = K["launchers"]["rglru_scan"].bwd_launches
    h = ops.rglru_scan(a, b, h0)
    grads = torch.autograd.grad(h, leaves, dy)
    launched = K["launchers"]["rglru_scan"].bwd_launches - before
    name = dtype_name(dtype)
    label = f"rglru_scan backward {case} h0={with_h0} {name}"
    bitwise = None
    if case == RG_TRAIN:
        again = torch.autograd.grad(ops.rglru_scan(a, b, h0), leaves, dy)
        bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
        del again
        if not bitwise:
            raise AssertionError(f"{label}: two calls gave different "
                                 f"gradients")
    plain_in = [t.detach().requires_grad_(True) for t in leaves]
    plain_out = ref.rglru_scan_ref(*plain_in[:2],
                                   plain_in[2] if with_h0 else None)
    want = torch.autograd.grad(plain_out, plain_in, dy, retain_graph=True)
    errs = [float((got.float() - w.float()).abs().max())
            / max(1.0, float(w.float().abs().max()))
            for got, w in zip(grads, want)]
    if launched != 1 or not max(errs) < BWD_TOL[name]:
        raise AssertionError(f"{label}: {launched} backward launches, "
                             f"errors {errs} (tol {BWD_TOL[name]})")
    esz = 2 if dtype == torch.bfloat16 else 4
    hd = h.detach()
    h0d = None if h0 is None else h0.detach()
    bound = least_ms(5 * esz * B * S * W + (8 * B * W if with_h0 else 0),
                     3 * B * S * W, "float32")
    abs_err = max(float((got.float() - w.float()).abs().max())
                  for got, w in zip(grads, want))
    return timed_case(
        torch, label, abs_err,
        lambda: rglru_scan_bwd_kernel(a.detach(), hd, dy, h0d),
        lambda: torch.autograd.grad(plain_out, plain_in, dy,
                                    retain_graph=True), None,
        20 if S <= 512 else 10, bound,
        {"shape": list(case), "h0": with_h0, "dtype": name,
         "grad_errs": errs, "bitwise_repeat": bitwise,
         "plan": rglru_bwd_plan(torch, B, S, W, dtype)}, plain_n=1)


def rglru_bwd_plan(torch, B, S, W, dtype) -> dict:
    """The backward's plan for this shape on this card, its rows a thread
    and most threads a CTA held to the library's own."""
    from repro_torch.kernels.rglru_scan import kernel
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = kernel.bwd_library()
    got = (lib.rglru_scan_bwd_rows(), lib.rglru_scan_bwd_max_threads())
    if got != (kernel.BWD_ROWS, kernel.BWD_MAX_THREADS):
        raise AssertionError(f"rglru backward plan's (rows, threads) "
                             f"{(kernel.BWD_ROWS, kernel.BWD_MAX_THREADS)} "
                             f"differ from the kernel's {got}")
    return kernel.bwd_plan(B, S, W, dtype, sms)._asdict()


# ------------------------------------------------------------ train phase
def train_grads(torch, K, model, cfg, batch, labels, plain=False):
    """One step's loss and every parameter's gradient through
    ``api.forward`` + ``api.loss_fn``; ``plain``: with every kernel
    replaced by its plain version (autograd differentiates it)."""
    from repro_torch.models import api
    names, params = zip(*model.named_parameters())
    with plain_versions(K) if plain else contextlib.nullcontext():
        logits, aux = api.forward(model, batch, cfg)
        loss = api.loss_fn(logits, labels[:, :logits.shape[1]], aux)
        del logits
        grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def train_step_ms(torch, model, cfg, inputs, labels, runs=3):
    """One train step's forward, loss and gradients through the kernels,
    after a warm-up: the median and each of ``runs`` host-clock times
    (ms), each ending in a synchronising read of the loss (its gradients'
    kernels are queued before it on the same stream)."""
    train_grads(torch, None, model, cfg, inputs, labels)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        train_grads(torch, None, model, cfg, inputs, labels)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), times


def train_inputs_for(torch, cfg, batch, seq, seed=0):
    """The train driver's batch and labels from the synthetic pipeline's
    first batch."""
    from repro_torch.data.pipeline import SyntheticTextPipeline
    from repro_torch.launch.train import train_inputs
    tb = next(SyntheticTextPipeline(cfg.vocab_size, batch, seq, seed=seed))
    return train_inputs(cfg, tb.tokens, tb.labels, batch, seq, "cuda")


def train_grads_check(torch, K, label, cfg, batch, seq, need,
                      timed=False):
    """One train step's gradients of ``cfg`` at full width through the
    kernels, launches counted (``need``: exact counts), against the same
    step on the plain versions: the loss within 2e-2 of max(1, |loss|),
    every gradient within TRAIN_GRAD_TOL of its norm. ``timed``: also
    the step's time through the kernels (``train_step_ms``)."""
    from repro_torch.models import api
    t0 = time.perf_counter()
    model = api.build_params(cfg, seed=0, device="cuda")
    model.requires_grad_(True)
    inputs, labels = train_inputs_for(torch, cfg, batch, seq)
    reset_launches(K)
    loss, grads = train_grads(torch, K, model, cfg, inputs, labels)
    torch.cuda.synchronize()
    launches = read_launches(K)
    bad = {k: (launches[k], v) for k, v in need.items()
           if launches[k] != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, need) {bad}")
    loss_ref, ref = train_grads(torch, K, model, cfg, inputs, labels,
                                plain=True)
    rel = {}
    for n, gr in ref.items():
        if not bool(torch.isfinite(grads[n]).all()):
            raise AssertionError(f"{label}: gradient of {n} not finite")
        norm = float(gr.float().norm())
        diff = float((grads[n].float() - gr.float()).norm())
        rel[n] = diff / norm if norm else (0.0 if diff == 0 else
                                           float("inf"))
    worst = max(rel, key=rel.get)
    if not (abs(loss - loss_ref) <= 2e-2 * max(1.0, abs(loss_ref))
            and rel[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"{label}: loss {loss} vs plain {loss_ref}; "
                             f"worst gradient {worst} off by {rel[worst]} "
                             f"of its norm (tol {TRAIN_GRAD_TOL})")
    rec = {"model": label, "layers": cfg.num_layers, "batch": batch,
           "seq": seq, "loss": loss, "loss_plain": loss_ref,
           "grad_tensors": len(rel), "worst_grad_rel_err": rel[worst],
           "worst_grad": worst,
           "median_grad_rel_err": statistics.median(rel.values()),
           "launches": launches}
    del ref, grads
    if timed:
        rec["step_ms"], rec["step_ms_runs"] = train_step_ms(
            torch, model, cfg, inputs, labels)
    rec["seconds"] = time.perf_counter() - t0
    log(f"  {label}: " + json.dumps(rec))
    del model
    return rec


def train_memory_bytes(cfg, n_params, batch, seq) -> int:
    """The train step's peak, reckoned: bf16 weights and gradients, fp32
    moments (2 x 4 bytes), the logits (bf16, their fp32 copy and its
    gradient, the bf16 gradient: 12 bytes a value) and the checkpointed
    layer inputs (bf16)."""
    tokens = batch * seq
    return (2 * n_params + 2 * n_params + 8 * n_params
            + 12 * tokens * cfg.vocab_size
            + 2 * cfg.num_layers * tokens * cfg.d_model)


def train_full(torch, K):
    """Full-width, full-depth qwen3-4b: TRAIN_STEPS steps of the
    synthetic pipeline through ``launch.train.train`` (AdamW, remat on),
    with its launches counted: flash's forward twice per layer and step
    (the forward and its recompute), its backward ``BWD_PASSES[bf16]``
    kernels per layer and step. Fails on a loss or grad_norm that is not finite or
    if no parameter moved; prints how many parameter tensors changed
    (the warmup's lr, 3e-6 to 1.2e-5, is under the bf16 spacing of most
    weights; the norm gains start at zero and must move), the time per
    step, tokens/s and the peak memory."""
    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention.kernel import BWD_PASSES
    from repro_torch.launch import train as train_mod
    from repro_torch.models import api
    cfg = get_config(HI)
    n_params = sum(p.numel() for p in
                   api.build_params(cfg, device="meta").parameters())
    total = torch.cuda.get_device_properties(0).total_memory
    batch = TRAIN_B
    reckoned = train_memory_bytes(cfg, n_params, batch, TRAIN_S)
    cut = None
    if reckoned > 0.9 * total:
        batch = 1
        cut = (f"B{TRAIN_B} reckoned {reckoned / 1e9:.1f} GB of "
               f"{total / 1e9:.1f}: B1")
        reckoned = train_memory_bytes(cfg, n_params, batch, TRAIN_S)
    log(f"  qwen3-4b: {n_params / 1e9:.3f} B parameters; B{batch} "
        f"S{TRAIN_S} reckoned peak {reckoned / 1e9:.1f} GB of "
        f"{total / 1e9:.1f}" + (f" ({cut})" if cut else ""))
    model = api.build_params(cfg, seed=0, device="cuda")

    def fingerprints():
        # the sum of each tensor's bf16 bit patterns: any changed element
        # changes it (short of changes that cancel exactly)
        return {n: int(p.detach().view(torch.int16).sum(dtype=torch.int64))
                for n, p in model.named_parameters()}
    before = fingerprints()
    free(torch)
    stamps, metrics = [], []

    def on_step(step, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
    reset_launches(K)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train_mod.train(HI, steps=TRAIN_STEPS, batch=batch,
                             seq=TRAIN_S, reduced=False, seed=0,
                             log_every=1, device="cuda", model=model,
                             on_step=on_step)
    launches = read_launches(K)
    peak = torch.cuda.max_memory_allocated()
    after = fingerprints()
    changed = [n for n in after if after[n] != before[n]]
    norms = [n for n in after if n.endswith(("ln1", "ln2", "final_norm",
                                             "q_norm", "k_norm"))]
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    L = cfg.num_layers
    need = {"flash_attention": 2 * L * TRAIN_STEPS,
            "flash_attention_bwd": (BWD_PASSES[torch.bfloat16] * L
                                    * TRAIN_STEPS),
            "decode_attention": 0, "rglru_scan": 0, "rglru_scan_bwd": 0}
    rec = {"model": HI, "parameters": n_params, "layers": L,
           "batch": batch, "seq": TRAIN_S, "steps": TRAIN_STEPS,
           "remat": cfg.remat, "cut": cut, "losses": losses,
           "grad_norms": [m["grad_norm"] for m in metrics],
           "lrs": [m["lr"] for m in metrics], "step_s": step_s,
           "step_s_median_after_first": statistics.median(step_s[1:]),
           "tokens_per_s": batch * TRAIN_S
           / statistics.median(step_s[1:]),
           "peak_mem_bytes": peak, "reckoned_peak_bytes": reckoned,
           "tensors_changed": len(changed), "tensors": len(after),
           "norm_gains_changed": sum(n in changed for n in norms),
           "norm_gains": len(norms), "launches": launches}
    log(f"  qwen3-4b full depth: " + json.dumps(rec))
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    finite = all(math.isfinite(x) for x in losses + rec["grad_norms"])
    if bad or not finite or not changed:
        raise AssertionError(f"train: launches (got, need) {bad}; finite "
                             f"losses and grad norms {finite}; "
                             f"{len(changed)} tensors changed")
    del model
    return rec


# ----------------------------------------------------------- model phases
# --------------------------------------------------------------- mesh phase
#: a gradient that is not bit for bit the un-meshed one is held within
#: this share of its norm (and named)
MESH_TOL = 1e-3


def _whole(x):
    """A DTensor's whole tensor; a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _compare(label, want, got, tol=MESH_TOL):
    """name -> tensor maps: bit for bit, or each within ``tol`` of its
    norm. Returns (all bitwise, the names that are not, the worst
    relative difference)."""
    differ, worst = [], 0.0
    for n, w in want.items():
        g = _whole(got[n])
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {n}: {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if not bool((g == w).all()):
            differ.append(n)
            norm = float(w.float().norm())
            rel = float((g.float() - w.float()).norm()) / (norm or 1.0)
            worst = max(worst, rel)
    if worst > tol:
        raise AssertionError(f"{label}: {len(differ)} tensors differ, the "
                             f"worst by {worst} of its norm: {differ[:8]}")
    return not differ, differ, worst


def mesh_train_check(torch, K, mesh, cfg, batch, seq, dev="cuda"):
    """Phase 11 (b): the meshed loss and gradients, and one meshed train
    step, against the un-meshed ones on the same weights and batch."""
    from repro_torch.config import InputShape
    from repro_torch.kernels.flash_attention.kernel import BWD_PASSES
    from repro_torch.launch import steps
    from repro_torch.launch.train import train_inputs
    from repro_torch.data.pipeline import SyntheticTextPipeline
    from repro_torch.models import api
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.specs import unshard_model
    tb = next(SyntheticTextPipeline(cfg.vocab_size, batch, seq, seed=0))
    inputs, labels = train_inputs(cfg, tb.tokens, tb.labels, batch, seq, dev)
    model = api.build_params(cfg, seed=0, device=dev).requires_grad_(True)
    loss0, grads0 = steps.loss_and_grads(cfg, None, model, inputs, labels)
    # a gradient the un-meshed path does not repeat bit for bit (the
    # embedding lookup's backward accumulates repeated tokens' rows with
    # index_put_, in an order the device's threads choose) cannot be held
    # bit for bit to it either
    _, again = steps.loss_and_grads(cfg, None, model, inputs, labels)
    unsteady = sorted(n for n in grads0 if not torch.equal(grads0[n],
                                                           again[n]))
    del again
    reset_launches(K)
    loss1, grads1 = steps.loss_and_grads(cfg, mesh, model, inputs, labels)
    torch.cuda.synchronize()
    launches = read_launches(K)
    L = cfg.num_layers
    need = {"flash_attention": (2 if cfg.remat else 1) * L,
            "flash_attention_bwd": BWD_PASSES[torch.bfloat16] * L}
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"mesh train: launches (got, need) {bad}")
    placements = sorted({str(tuple(g.placements)) for g in grads1.values()})
    g_bits, g_differ, g_worst = _compare("mesh gradients", grads0, grads1)
    if set(g_differ) - set(unsteady):
        raise AssertionError(
            f"mesh gradients: {sorted(set(g_differ) - set(unsteady))} "
            f"differ from the un-meshed ones, which repeat bit for bit")
    loss_bits = bool(torch.equal(loss0, _whole(loss1)))
    del grads0, grads1
    unshard_model(model)
    del model
    free(torch)
    shape = InputShape("t", seq, batch, "train")
    after, metrics = {}, {}
    for key, m in (("unmeshed", None), ("meshed", mesh)):
        model = api.build_params(cfg, seed=0, device=dev).requires_grad_(True)
        fn, _ = steps.make_train_step(cfg, m, shape, grad_accum=1)
        model, opt, met = fn(model, adamw_init(dict(model.named_parameters())),
                             inputs, labels)
        metrics[key] = met
        after[key] = dict(unshard_model(model).named_parameters())
        del opt, model
        free(torch)
    p_bits, p_differ, p_worst = _compare("mesh step parameters",
                                         after["unmeshed"], after["meshed"])
    step_bits = all(bool(torch.equal(metrics["unmeshed"][k],
                                     metrics["meshed"][k]))
                    for k in ("loss", "grad_norm", "lr"))
    rec = {"model": f"{cfg.name} ({L} layers)", "batch": batch, "seq": seq,
           "loss_unmeshed": float(loss0), "loss_meshed": float(_whole(loss1)),
           "loss_bitwise": loss_bits, "grads_bitwise": g_bits,
           "unmeshed_not_repeatable": unsteady,
           "grads_differ": g_differ, "grads_worst_rel": g_worst,
           "grad_placements": placements, "launches": launches,
           "step_metrics_bitwise": step_bits, "step_params_bitwise": p_bits,
           "step_params_differ": p_differ, "step_params_worst_rel": p_worst,
           "grad_norm": float(metrics["meshed"]["grad_norm"])}
    if not (loss_bits or abs(float(loss0) - float(_whole(loss1)))
            <= MESH_TOL * max(1.0, abs(float(loss0)))):
        raise AssertionError(f"mesh train: loss {rec['loss_meshed']} vs "
                             f"{rec['loss_unmeshed']}")
    del after
    return rec


def mesh_generate_check(torch, K, mesh, cfg, batch, prompt, dev="cuda"):
    """Phase 11 (c): meshed prefill + GEN_STEPS meshed serve steps against
    phase 6's un-meshed ``generate`` on the same weights and tokens."""
    from repro_torch.config import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.sharding.specs import unshard_model
    model = api.build_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           dtype=torch.int32, device=dev, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (GEN_STEPS, batch, 1),
                         dtype=torch.int32, device=dev, generator=g)
    want, want_ms, caches = generate(torch, model, tokens, prompt, toks, cfg)
    del caches
    pf, _ = steps.make_prefill_step(
        cfg, mesh, InputShape("p", prompt, batch, "prefill"),
        extra_capacity=GEN_STEPS)
    sv, _ = steps.make_serve_step(
        cfg, mesh, InputShape("d", prompt + GEN_STEPS, batch, "decode"))
    reset_launches(K)
    logits, caches = pf(model, tokens)
    got, ms = [logits], []
    for i in range(GEN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = sv(model, toks[i], prompt + i, caches)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        got.append(logits)
    launches = read_launches(K)
    L = cfg.num_layers
    need = {"flash_attention": L, "decode_attention": GEN_STEPS * L}
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"mesh generate: launches (got, need) {bad}")
    placements = str(tuple(got[0].placements))
    bits = [bool(torch.equal(w, _whole(x))) for w, x in zip(want, got)]
    if not all(bits):
        worst = max(float((w.float() - _whole(x).float()).abs().max())
                    for w, x in zip(want, got))
        raise AssertionError(f"mesh generate: steps bitwise {bits}, worst "
                             f"|diff| {worst}")
    rec = {"model": cfg.name, "batch": batch, "prompt": prompt,
           "steps": GEN_STEPS, "logits_bitwise_steps": sum(bits),
           "logits_placements": placements, "launches": launches,
           "decode_step_ms_median_meshed": statistics.median(ms),
           "decode_step_ms_median_unmeshed": statistics.median(want_ms),
           "decode_step_ms_meshed": ms, "decode_step_ms_unmeshed": want_ms}
    del caches, got, want
    unshard_model(model)
    del model
    return rec


def mesh_moe_prefill_check(torch, K, mesh, cfg, batch, prompt,
                           dev="cuda"):
    """Phase 11 (d): meshed prefill of an MoE model on the (1, 1) mesh,
    which takes the block's single-device branch (ep = 1), against the
    un-meshed prefill."""
    from repro_torch.config import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import api, moe
    from repro_torch.sharding.specs import unshard_model
    model = api.build_params(cfg, seed=0, device=dev)
    rescale_qk(torch, model)                 # as phase 6's llama4 run
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           dtype=torch.int32, device=dev, generator=g)
    with torch.inference_mode():
        want, caches = api.prefill(model, tokens, cfg)
    del caches
    free(torch)
    calls = {"single": 0}
    real = moe._replicated_block

    def single(*a, **k):
        calls["single"] += 1
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the (1, 1) mesh (ep = 1) must take the "
                             "single-device branch")
    pf, _ = steps.make_prefill_step(cfg, mesh,
                                    InputShape("p", prompt, batch, "prefill"))
    reset_launches(K)
    with mock.patch.object(moe, "_replicated_block", single), \
            mock.patch.object(moe, "_expert_parallel_block", refuse):
        got, caches = pf(model, tokens)
    launches = read_launches(K)
    del caches
    L = cfg.num_layers
    if calls["single"] != L:
        raise AssertionError(f"mesh moe: {calls['single']} single-device "
                             f"blocks for {L} layers")
    if launches["flash_attention"] != L:
        raise AssertionError(f"mesh moe: flash launches "
                             f"{launches['flash_attention']}, need {L}")
    bits = bool(torch.equal(want, _whole(got)))
    if not bits:
        raise AssertionError(
            "mesh moe: prefill logits differ by "
            f"{float((want.float() - _whole(got).float()).abs().max())}")
    rec = {"model": cfg.name, "batch": batch, "prompt": prompt,
           "single_device_blocks": calls["single"], "logits_bitwise": bits,
           "launches": launches}
    unshard_model(model)
    del model, want, got
    return rec


def mesh_train_cost(torch, K, mesh, cfg, batch, seq, steps_n, unmeshed,
                    repeatable, dev="cuda"):
    """Phase 11 (e): the meshed full-depth train step on phase 4 (b)'s
    weights (seed 0) and batches (the synthetic pipeline, seed 0), each
    step ended by a synchronise as ``train()``'s ``on_step`` ends it
    there, beside that un-meshed run's numbers (``unmeshed``). The losses
    must be phase 4 (b)'s bit for bit, or within MESH_TOL where (b)
    found two un-meshed runs' gradients to differ (``repeatable``
    false)."""
    from repro_torch.config import InputShape
    from repro_torch.data.pipeline import SyntheticTextPipeline
    from repro_torch.kernels.flash_attention.kernel import BWD_PASSES
    from repro_torch.launch import steps
    from repro_torch.launch.train import train_inputs
    from repro_torch.models import api
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.specs import unshard_model
    model = api.build_params(cfg, seed=0, device=dev).requires_grad_(True)
    opt = adamw_init(dict(model.named_parameters()))
    fn, _ = steps.make_train_step(cfg, mesh,
                                  InputShape("t", seq, batch, "train"),
                                  grad_accum=1)
    pipe = SyntheticTextPipeline(cfg.vocab_size, batch, seq, seed=0).start()
    free(torch)
    reset_launches(K)
    torch.cuda.reset_peak_memory_stats()
    stamps, losses = [], []
    t0 = time.perf_counter()
    try:
        for _ in range(steps_n):
            tb = next(pipe)
            inputs, labels = train_inputs(cfg, tb.tokens, tb.labels, batch,
                                          seq, dev)
            model, opt, m = fn(model, opt, inputs, labels)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
    finally:
        pipe.stop()
    launches = read_launches(K)
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    med = statistics.median(step_s[1:])
    rec = {"model": cfg.name, "batch": batch, "seq": seq, "steps": steps_n,
           "meshed": {"step_s": step_s, "step_s_median_after_first": med,
                      "tokens_per_s": batch * seq / med,
                      "peak_mem_bytes": peak, "losses": losses,
                      "launches": launches},
           "unmeshed": {k: unmeshed[k] for k in
                        ("step_s", "step_s_median_after_first",
                         "tokens_per_s", "peak_mem_bytes", "losses")}}
    rec["meshed_over_unmeshed_step"] = (
        med / unmeshed["step_s_median_after_first"])
    rec["losses_bitwise"] = losses == unmeshed["losses"]
    unshard_model(model)
    del model, opt
    L = cfg.num_layers
    need = {"flash_attention": 2 * L * steps_n,
            "flash_attention_bwd": BWD_PASSES[torch.bfloat16] * L * steps_n}
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"mesh train cost: launches (got, need) {bad}")
    near = all(abs(a - b) <= MESH_TOL * max(1.0, abs(b))
               for a, b in zip(losses, unmeshed["losses"]))
    if not rec["losses_bitwise"] and (repeatable or not near):
        raise AssertionError(f"mesh train cost: meshed losses {losses}, "
                             f"un-meshed {unmeshed['losses']}")
    return rec


def mesh_phase(torch, K, train_qwen, smi):
    """Phase 11: (a) the host mesh, then (b)-(e); the group is destroyed at
    the end whatever happens."""
    import torch.distributed as dist

    from repro_torch.config import get_config
    from repro_torch.launch.mesh import destroy_host_group, make_host_mesh
    if dist.is_initialized():
        raise AssertionError("a process group outlived its phase")
    mesh = make_host_mesh()
    out = {"a": {"mesh": str(mesh), "backend": dist.get_backend(),
                 "world": dist.get_world_size(), "card": smi}}
    log("  (a) " + json.dumps(out["a"]))
    try:
        out["b"] = mesh_train_check(torch, K, mesh,
                                    get_config(HI).replace(num_layers=2),
                                    TRAIN_B, TRAIN_S)
        log("  (b) " + json.dumps(dict(out["b"], card=smi)))
        free(torch)
        (_, hi_batch, hi_prompt) = GENERATE[1]
        out["c"] = mesh_generate_check(torch, K, mesh, get_config(HI),
                                       hi_batch, hi_prompt)
        log("  (c) " + json.dumps(dict(out["c"], card=smi)))
        free(torch)
        (name, batch, prompt, _) = MOE_GENERATE[0]
        out["d"] = mesh_moe_prefill_check(torch, K, mesh, get_config(name),
                                          batch, prompt)
        log("  (d) " + json.dumps(dict(out["d"], card=smi)))
        free(torch)
        out["e"] = mesh_train_cost(
            torch, K, mesh, get_config(HI), train_qwen["batch"], TRAIN_S,
            TRAIN_STEPS, train_qwen, not out["b"]["unmeshed_not_repeatable"])
        log("  (e) " + json.dumps(dict(out["e"], card=smi)))
        free(torch)
    finally:
        destroy_host_group()
    return out


def launchers(K) -> dict:
    """The kernels' wrappers as imported, whose ``launches`` count kernel
    launches (a patched module attribute does not hide them)."""
    return {name: getattr(K[name][0], name) for name in KERNELS}


def reset_launches(K) -> None:
    for fn in K["launchers"].values():
        fn.launches = 0
        if hasattr(fn, "bwd_launches"):
            fn.bwd_launches = 0
    K["launchers"]["flash_attention"].launches_by_shape.clear()


def read_launches(K) -> dict:
    """Each kernel's launches since the last reset, and its backward's
    (``<name>_bwd``: kernels launched, flash's ``BWD_PASSES`` a call)."""
    out = {name: fn.launches for name, fn in K["launchers"].items()}
    out.update({f"{name}_bwd": fn.bwd_launches
                for name, fn in K["launchers"].items()
                if hasattr(fn, "bwd_launches")})
    return out


def shape_key(case) -> str:
    return "B{} H{} Kh{} Sq{} Sk{} D{}".format(*case[:6])


def read_flash_shapes(K) -> dict:
    """flash launches per (B, H, Kh, Sq, Sk, D) since the last reset."""
    by_shape = K["launchers"]["flash_attention"].launches_by_shape
    return {shape_key(k): n for k, n in sorted(by_shape.items())}


@contextlib.contextmanager
def plain_versions(K):
    """Every kernel wrapper replaced by its plain version."""
    with contextlib.ExitStack() as stack:
        for name in KERNELS:
            ops, ref = K[name]
            stack.enter_context(mock.patch.object(
                ops, name, getattr(ref, f"{name}_ref")))
        yield


@contextlib.contextmanager
def checked_calls(K):
    """Every kernel call also runs the plain version on the same inputs
    and is held to it: max|kernel - plain| within the type's tolerance
    (rglru_scan's in fp32) of max(1, max|plain|). Yields the worst ratio
    of that error to its limit per kernel, and the calls checked."""
    worst = {name: 0.0 for name in KERNELS}
    calls = {name: 0 for name in KERNELS}
    with contextlib.ExitStack() as stack:
        for name in KERNELS:
            ops, ref = K[name]

            def checked(*args, _name=name, _real=K["launchers"][name],
                        _plain=getattr(ref, f"{name}_ref"), **kw):
                out = _real(*args, **kw)
                want = _plain(*args, **kw)
                dt = dtype_name(out.dtype)
                tol = (RGLRU_TOL if _name == "rglru_scan" and dt == "float32"
                       else TOL[dt])
                diff = float((out.float() - want.float()).abs().max())
                limit = tol * max(1.0, float(want.float().abs().max()))
                if not diff <= limit:
                    raise AssertionError(
                        f"{_name} on the path's inputs {tuple(args[0].shape)}"
                        f": max|kernel - plain| {diff} > {limit}")
                worst[_name] = max(worst[_name], diff / limit)
                calls[_name] += 1
                return out
            # the wrapper counts on the name it is patched under: these
            # comparison launches land here, not on the path's counter
            checked.launches = checked.bwd_launches = 0
            checked.launches_by_shape = collections.Counter()
            stack.enter_context(mock.patch.object(ops, name, checked))
        yield {"worst_err_to_limit": worst, "calls": calls}


def close_enough(label, y, y_ref, rel=2e-2):
    """bf16 agreement: max|kernel - plain| within ``rel`` of max|plain|
    (of the activations, where a block's output is the encoder-decoder's
    (encoder output, activations) state)."""
    if isinstance(y, tuple):
        y, y_ref = y[1], y_ref[1]
    diff = float((y.float() - y_ref.float()).abs().max())
    scale = float(y_ref.float().abs().max())
    if not diff <= rel * scale:
        raise AssertionError(f"{label}: max|kernel - plain| {diff} > "
                             f"{rel} * {scale}")
    return diff, scale


def ssm_forms_check(torch, model, tokens, logits, cfg):
    """mamba2 runs no kernel, so its check holds its two forms to each
    other, layer by layer down the whole depth: on the forward's input to
    layer i, the chunked scan over S tokens against the recurrent decode
    of the last token from the cache of the first S - 1 (each held within
    ``close_enough``). Beside it, the two paths run apart, as prefill of
    S - 1 tokens + one ``decode_step`` does: their last rows' difference
    after each layer, and the whole model's last-position logits against
    ``forward``'s, reported, not held. The random-weight model is not
    chaotic: each layer's two forms agree within 0.5 % from the same
    input, and the two paths drift apart steadily as their bf16
    roundings add up, about as the square root of depth (0.2 % of the
    output's size after one layer, 2.3 % after 16, 4.8 % after 64), to
    5.7 % of max|logit|: past 2e-2 by accumulation, not by divergence."""
    from repro_torch.models import api, mamba2, transformer as tfm

    def rel(a, b):
        return (float((a.float() - b.float()).abs().max())
                / float(b.float().abs().max()))
    x = tfm.embed_tokens(model, tokens, cfg)
    head, last = x[:, :-1], x[:, -1:]          # the prefill + decode path
    local, apart = [], []
    for i, lp in enumerate(model.layers):
        full = mamba2.layer_apply(lp, x, cfg)
        _, cache = mamba2.layer_apply(lp, x[:, :-1], cfg, return_cache=True)
        step, _ = mamba2.layer_decode(lp, x[:, -1:], cache, cfg)
        close_enough(f"{cfg.name} layer {i}: recurrent vs chunked", step,
                     full[:, -1:])
        local.append(rel(step, full[:, -1:]))
        head, cache = mamba2.layer_apply(lp, head, cfg, return_cache=True)
        last, _ = mamba2.layer_decode(lp, last, cache, cfg)
        apart.append(rel(last, full[:, -1:]))
        x = full
    S = tokens.shape[1]
    _, caches = api.prefill(model, tokens[:, :-1], cfg)
    step, _ = api.decode_step(model, tokens[:, -1:], S - 1, caches, cfg)
    want = logits[:, -1:]
    ldiff = float((step.float() - want.float()).abs().max())
    lscale = float(want.float().abs().max())
    L = cfg.num_layers
    depths = sorted({d for d in (1, 2, 4, 8, 16, 32) if d < L} | {L})
    return (f"every layer max|recurrent - chunked| / max|out| <= "
            f"{max(local):.4g} (held; layer 0 {local[0]:.4g}); the two "
            f"paths' last rows apart after layers "
            + ", ".join(f"{d}: {apart[d - 1]:.3g}" for d in depths)
            + f"; last-position logits max|prefill + decode_step - "
            f"forward| {ldiff:.4g} of max|logit| {lscale:.4g} (reported)")


def model_check(torch, K, name, batch, seq, keep=False):
    """Full-size model: finite logits of the right shape, and its first
    block of each kind with the kernels against the plain versions (for
    mamba2, its chunked form against its recurrent one; for the
    encoder-decoder, an encoder layer and a decoder layer, self- and
    cross-attention)."""
    from repro_torch.config import get_config
    from repro_torch.models import api, encdec, rglru, segmentation
    from repro_torch.models import transformer as tfm
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = api.build_params(cfg, seed=0, device="cuda")
    inputs = api.make_batch(cfg, batch, seq, device="cuda")
    positions = seq
    if cfg.family == "vlm":                  # the patches, then the text
        positions = cfg.num_patches + inputs[1].shape[1]
    notes = []
    with torch.inference_mode():
        logits, _ = api.forward(model, inputs, cfg)
        if tuple(logits.shape) != (batch, positions, cfg.vocab_size):
            raise AssertionError(f"{name} logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name} logits are not finite")
        if cfg.family == "encdec":
            frames, tokens = inputs
            state = (encdec.encode(model, frames, cfg),
                     tfm.embed_tokens(model, tokens, cfg))
            blocks = [("encoder layer 0", model.enc_layers[0],
                       encdec.enc_layer_apply,
                       frames.to(logits.dtype) @ model.enc_in),
                      ("decoder layer 0 (self + cross)", model.dec_layers[0],
                       segmentation._dec_layer, state)]
        elif cfg.family == "vlm":
            x = tfm.embed_tokens(model, inputs[1], cfg, inputs[0])
            blocks = [("layer 0", model.layers[0],
                       segmentation.layer_fn(cfg, 0), x)]
        elif cfg.family == "hybrid":
            x = tfm.embed_tokens(model, inputs, cfg)
            kinds = rglru.block_kinds(cfg)
            blocks = [(kind, model.blocks[kinds.index(kind)],
                       rglru.rec_block_apply if kind == "rec"
                       else rglru.attn_block_apply, x)
                      for kind in ("rec", "attn")]
        elif cfg.family == "ssm":
            blocks = []
            notes.append(ssm_forms_check(torch, model, inputs, logits, cfg))
        else:
            x = tfm.embed_tokens(model, inputs, cfg)
            blocks = [("layer 0", model.layers[0],
                       segmentation.layer_fn(cfg, 0), x)]
        for label, block, fn, inp in blocks:
            y = fn(block, inp, cfg)
            with plain_versions(K):
                y_ref = fn(block, inp, cfg)
            diff, scale = close_enough(f"{name} {label}", y, y_ref)
            notes.append(f"{label} max|kernel - plain| {diff:.4g} of "
                         f"max|out| {scale:.4g}")
    torch.cuda.synchronize()
    log(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"logits {tuple(logits.shape)} finite; " + "; ".join(notes)
        + f" ({time.perf_counter() - t0:.1f} s)")
    del logits
    return model if keep else None


def prefill_times(torch, model, inputs, cfg, runs: int = 3) -> list:
    """Host-clock ms of ``runs`` synchronised ``api.prefill`` calls (a
    cache GEN_STEPS beyond the prompt), after one warm-up call."""
    from repro_torch.models import api
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            api.prefill(model, inputs, cfg, extra_capacity=GEN_STEPS)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times[1:]


def generate(torch, model, inputs, start, steps, cfg):
    """Prefill ``inputs`` (a cache GEN_STEPS beyond the prompt), then one
    ``decode_step`` per row of ``steps`` at positions ``start``,
    ``start`` + 1, ...; returns the logits of every step, each step's
    host-clock ms (around a synchronised call) and the caches."""
    from repro_torch.models import api
    times = []
    with torch.inference_mode():
        logits, caches = api.prefill(model, inputs, cfg,
                                     extra_capacity=GEN_STEPS)
        outs = [logits]
        for i in range(len(steps)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = api.decode_step(model, steps[i], start + i,
                                             caches, cfg)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            outs.append(logits)
    return outs, times, caches


def prompt_inputs(torch, cfg, batch, prompt, g):
    """The generate phase's prompt from generator ``g``: ``prompt`` tokens,
    after the encoder-decoder's frames (0.02 N(0, 1), in the config's
    dtype) or the VLM's stub patches; and the position of its first
    decoded token."""
    from repro_torch.models import vlm
    from repro_torch.models.layers import torch_dtype
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           dtype=torch.int32, device="cuda", generator=g)
    if cfg.family == "encdec":
        frames = torch.randn(batch, cfg.encoder_frames, cfg.d_model,
                             device="cuda", generator=g) * 0.02
        return (frames.to(torch_dtype(cfg.dtype)), tokens), prompt
    if cfg.family == "vlm":
        return ((vlm.stub_patches(cfg, batch, device="cuda"), tokens),
                cfg.num_patches + prompt)
    return tokens, prompt


def attention_launches(cfg) -> dict:
    """Launches of each kernel in a prefill and in one decode step: flash
    per attention layer of the prompt (the encoder-decoder's encoder,
    decoder self- and cross-attention) and per cross-attention of a step;
    decode per self-attention layer of a step; rglru_scan per rec block
    of the prompt (a decode step's rec blocks take one step of the
    recurrence, not a scan)."""
    from repro_torch.models import rglru
    L = cfg.num_layers
    if cfg.family == "hybrid":
        attn = rglru.block_kinds(cfg).count("attn")
        return {"prefill": {"flash_attention": attn, "rglru_scan": L - attn},
                "step": {"decode_attention": attn}}
    if cfg.family == "encdec":
        Le = cfg.num_encoder_layers or L
        Ld = cfg.num_decoder_layers or L
        return {"prefill": {"flash_attention": Le + 2 * Ld},
                "step": {"decode_attention": Ld, "flash_attention": Ld}}
    # the SSM has no attention; MLA (deepseek-v2) attends with torch ops
    attn = 0 if cfg.family == "ssm" or cfg.use_mla else L
    return {"prefill": {"flash_attention": attn},
            "step": {"decode_attention": attn}}


def rescale_qk(torch, model) -> None:
    """Scale every attention's wq and wk by sqrt(heads / d_model). The
    reference init's fan_in for them is the head count (shape[-2]): q and
    k entries then have a standard deviation near sqrt(d_model / heads)
    and, without qk-norm, the attention logits one of 50-200, so every
    softmax row is near one-hot and a one-ulp bf16 difference in a block
    can move a row's winning key. With fan_in d_model the logits have a
    standard deviation near 1 and the model is not chaotic."""
    from repro_torch.models.transformer import Attention
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Attention):
                for w in (m.wq, m.wk):
                    w.mul_((w.shape[-2] / w.shape[0]) ** 0.5)


def generate_check(torch, K, name, model, batch, prompt, hold_logits,
                   rescale=False):
    """Prefill ``prompt`` tokens (after the frames or patches of the
    encoder-decoder and the VLM), then GEN_STEPS decode steps (tokens
    drawn up front, so every run sees the same ones). Three runs: the
    kernels' (timed, launches counted: flash and decode exactly); the
    plain versions' (end-to-end logits compared with the kernels' at
    every step, and held to them when ``hold_logits``); and one where
    every kernel call is held to its plain version on the same inputs.
    ``rescale``: a model built here gets ``rescale_qk``. An MoE model's
    plain run is given the kernels' run's expert choices
    (``routed_as``)."""
    from repro_torch.config import get_config
    from repro_torch.models import api
    cfg = get_config(name)
    if model is None:
        model = api.build_params(cfg, seed=0, device="cuda")
        if rescale:
            rescale_qk(torch, model)
    g = torch.Generator(device="cuda").manual_seed(1)
    inputs, start = prompt_inputs(torch, cfg, batch, prompt, g)
    steps = torch.randint(0, cfg.vocab_size, (GEN_STEPS, batch, 1),
                          dtype=torch.int32, device="cuda", generator=g)

    def run():
        return generate(torch, model, inputs, start, steps, cfg)

    moe = cfg.family == "moe"
    prefill = prefill_times(torch, model, inputs, cfg)
    free(torch)
    reset_launches(K)
    with routed_as() if moe else contextlib.nullcontext() as routing:
        outs, times, caches = run()
    launches = read_launches(K)
    with plain_versions(K), (routed_as(routing) if moe else
                             contextlib.nullcontext()) as forced:
        ref_outs, _, _ = run()
    del routing
    with checked_calls(K) as checked:
        run()
    per = attention_launches(cfg)
    need = {k: per["prefill"].get(k, 0) + GEN_STEPS * per["step"].get(k, 0)
            for k in KERNELS}
    exact = ("decode_attention", "flash_attention")
    if any(launches[k] != need[k] for k in exact) or any(
            launches[k] < v for k, v in need.items()):
        raise AssertionError(f"{name} generate: launches {launches}, "
                             f"need {need} (decode and flash exactly)")
    rel = []
    for i, (o, r) in enumerate(zip(outs, ref_outs)):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{name} step {i}: logits not finite")
        if hold_logits:
            close_enough(f"{name} generate step {i}", o, r)
        rel.append(float((o.float() - r.float()).abs().max())
                   / float(r.float().abs().max()))
    agree = sum(int((o.argmax(-1) == r.argmax(-1)).all())
                for o, r in zip(outs, ref_outs))
    kv = [getattr(c, "self_kv", c) for c in caches]
    kv = [c for c in kv if hasattr(c, "pos")]
    if kv:
        size = {"cache_slots": kv[0].capacity}
    else:                        # SSM: a fixed-size state and conv buffers
        size = {"state_bytes": sum(t.numel() * t.element_size()
                                   for c in caches for t in c)}
    rec = {"model": name, "batch": batch, "prompt": prompt,
           "first_decode_position": start, "steps": GEN_STEPS, **size,
           "launches": launches,
           "prefill_ms_median": statistics.median(prefill),
           "prefill_ms": prefill,
           "decode_step_ms_median": statistics.median(times),
           "decode_step_ms": times, "logits_held": hold_logits,
           "qk_rescaled": rescale,
           "logits_rel_err_per_step": rel, "argmax_agree_steps": agree,
           "per_call_check": checked}
    if moe:
        rec["tokens_rerouted_by_plain"] = forced["tokens_rerouted"]
        rec["routed_tokens"] = forced["tokens"]
    log(f"  {name}: " + json.dumps(rec))
    del model, caches, outs, ref_outs
    return rec


def flash_per_invocation(name, cross=False) -> int:
    """flash launches of one serving invocation: one per attention layer
    (the hybrid's attn blocks; none for the SSM; the encoder-decoder's
    encoder layers and its decoder's self- and cross-attention); with
    ``cross``, those of the cross-attention alone (Sq != Sk), which are
    also the flash launches of a decode step."""
    from repro_torch.config import get_config
    per = attention_launches(get_config(name))
    return per["step" if cross else "prefill"].get("flash_attention", 0)


def serve_run(torch, K, high, low, mode):
    """A serving path: serve_pair of (high, low) at full size under
    ``mode``, with every launch counter set to 0 before it and read after
    it: flash exactly the invocations' attention layers, rglru_scan at
    least their rec blocks."""
    from repro_torch.config import get_config
    from repro_torch.launch.serve import serve_pair
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K)
    t0 = time.perf_counter()
    out = serve_pair(high, low, mode=mode, reduced=False, device="cuda",
                     requests=REQUESTS, measure_runs=MEASURE_RUNS,
                     verbose=False)
    launches = read_launches(K)
    by_shape = read_flash_shapes(K)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    free(torch)
    runs = 1 + MEASURE_RUNS + REQUESTS        # warmup, measured, served
    need = {"flash_attention": runs * (flash_per_invocation(high)
                                       + flash_per_invocation(low))}
    cross = sum(n for k, n in K["launchers"]["flash_attention"]
                .launches_by_shape.items() if k[3] != k[4])
    need_cross = runs * (flash_per_invocation(high, cross=True)
                         + flash_per_invocation(low, cross=True))
    for name in (high, low):
        rec_blocks = attention_launches(get_config(name))["prefill"].get(
            "rglru_scan", 0)
        if rec_blocks:
            need["rglru_scan"] = need.get("rglru_scan", 0) + rec_blocks * runs
    rec = dict(out, high=high, low=low, launches=launches,
               flash_launches_by_shape=by_shape, peak_mem_bytes=peak,
               wall_s=wall)
    log(f"  {high} + {low} {mode}: " + json.dumps(rec))
    short = {k: v for k, v in need.items() if launches[k] < v}
    if (short or launches["flash_attention"] != need["flash_attention"]
            or cross != need_cross):
        raise AssertionError(f"{high} + {low} {mode}: launches {launches}, "
                             f"{cross} with Sq != Sk; the run needs at "
                             f"least {need} (flash exactly), {need_cross} "
                             f"with Sq != Sk")
    if not (out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0):
        raise AssertionError(f"{mode}: JCTs {out}")
    return rec


def replay_check(torch, svc, batch) -> dict:
    """Each segment of ``svc`` (a ``SegmentedService`` whose graphs were
    captured) replayed from its graph against its body run eagerly on the
    same input, chained through the replays: bit for bit, else an error
    naming the segment and its largest difference."""
    def leaves(x):
        return x if isinstance(x, tuple) else (x,)
    state, kinds = batch, collections.Counter()
    for seg in svc.segments:
        want, got = seg.fn.eager(state), seg.fn(state)
        if not all(torch.equal(a, b) for a, b in zip(leaves(want),
                                                     leaves(got))):
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(leaves(want), leaves(got)))
            raise AssertionError(f"{seg.name}: the replay differs from the "
                                 f"eager segment by up to {diff}")
        kinds[seg.name.rsplit("/", 1)[-1]] += 1
        state = got
    return {"segments_bitwise": dict(kinds),
            "graphs": sum(len(seg.fn.graphed.captured)
                          for seg in svc.segments)}


def segment_profile(torch, high, low):
    """Where a request's time goes: the measurement phase's per-run JCTs,
    SK (mean segment time incl. its device sync) and SG (host gap after
    it) per KernelID, beside the device time of one layer (or one block
    of each kind; for the encoder-decoder its whole encode segment and
    one decoder layer) alone; then each segment's replay held to its
    eager body (``replay_check``)."""
    from repro_torch.config import get_config
    from repro_torch.core.policy import Mode
    from repro_torch.models import encdec, rglru, segmentation
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import InferenceService, ServingSystem
    hi = InferenceService(get_config(high), priority=0, batch=2, seq=48,
                          host_gap=0.002)
    lo = InferenceService(get_config(low), priority=5, batch=4, seq=48)
    with ServingSystem(Mode.FIKIT, measure_runs=MEASURE_RUNS) as sys_:
        for svc in (hi, lo):
            jcts = sys_.onboard(svc)
            prof = sys_.profiles.get(svc.key)
            model, cfg = svc.svc.model, svc.cfg
            batch = svc.svc.make_input()
            state = svc.svc.segments[0].fn(batch)     # embed or encode
            n = 4
            if cfg.family == "hybrid":
                kinds = rglru.block_kinds(cfg)
                blocks = {
                    "rec": lambda: rglru.rec_block_apply(
                        model.blocks[kinds.index("rec")], state, cfg),
                    "attn": lambda: rglru.attn_block_apply(
                        model.blocks[kinds.index("attn")], state, cfg)}
            elif cfg.family == "encdec":
                frames, tokens = batch
                blocks = {
                    "encode": lambda: (encdec.encode(model, frames, cfg),
                                       tfm.embed_tokens(model, tokens,
                                                        cfg)),
                    "dec_layer": lambda: segmentation._dec_layer(
                        model.dec_layers[0], state, cfg)}
                n = 1        # the encoder alone is ~1000 launches
            else:
                fn = segmentation.layer_fn(cfg, 0)
                blocks = {"layer": lambda: fn(model.layers[0], state, cfg)}
            # a block is ~100 launches: 4 of them stay inside the card's
            # launch queue, so the host never blocks behind the sleep
            with torch.inference_mode():
                dev = {k: device_ms(torch, fn, n=n)
                       for k, fn in blocks.items()}
            rec = {"measure_jct_ms": [1e3 * j for j in jcts],
                   "SK_ms": {k.name: 1e3 * v for k, v in prof.SK.items()},
                   "SG_ms": {k.name: 1e3 * v for k, v in prof.SG.items()},
                   "block_device_ms": dev,
                   "replay": replay_check(torch, svc.svc, batch)}
            log(f"  {cfg.name}: " + json.dumps(rec))
    del hi, lo, state
    free(torch)


# ------------------------------------------------------------ MoE family
def register_moe_cuts() -> None:
    """Register the depth cuts of MOE_CUTS: the published config with
    fewer layers, every width kept."""
    from repro_torch.config import get_config, register
    for name, (base, layers) in MOE_CUTS.items():
        register(get_config(base).replace(name=name, num_layers=layers))


@contextlib.contextmanager
def routed_as(recorded=None):
    """Every MoE block's expert choices, in call order: recorded (with
    ``recorded`` None), or taken from ``recorded`` (a list, or a record
    yielded here), the gates renormalised from the block's own
    probabilities. A routing decision is a discontinuity: two runs that
    differ by rounding (the kernels against their plain versions, two
    forms of one model) may rank a token's experts otherwise where two
    probabilities nearly tie, and a dropped entry past an expert's
    capacity moves with them; a run given the other's choices differs
    from it by rounding alone. Yields the record: the choices, and how
    many tokens' own top-k (as a set) differed from the ones they were
    given."""
    from repro_torch.models import moe
    real = moe._route
    given = (recorded if recorded is None or isinstance(recorded, list)
             else recorded["idx"])
    rec = {"idx": [], "calls": 0, "tokens": 0, "tokens_rerouted": 0}

    def route(x2, p, cfg):
        probs, gates, idx = real(x2, p, cfg)
        if given is None:
            rec["idx"].append(idx)
        else:
            forced = given[rec["calls"]]
            rec["tokens"] += idx.shape[0]
            own = idx.sort(-1).values != forced.sort(-1).values
            rec["tokens_rerouted"] += int(own.any(-1).sum())
            g = probs.gather(-1, forced)
            gates, idx = g / (g.sum(-1, keepdim=True) + 1e-9), forced
        rec["calls"] += 1
        return probs, gates, idx
    with mock.patch.object(moe, "_route", route):
        yield rec


@contextlib.contextmanager
def counted_drops():
    """Entries dropped past an expert's capacity by every MoE block run
    inside (one device sync a block)."""
    from repro_torch.models import moe
    real = moe._dispatch
    rec = {"dropped": 0, "entries": 0}

    def dispatch(idx, C, E):
        order, dest, keep = real(idx, C, E)
        rec["dropped"] += int((~keep).sum())
        rec["entries"] += keep.numel()
        return order, dest, keep
    with mock.patch.object(moe, "_dispatch", dispatch):
        yield rec


def qwen3_moe_config(layers: int):
    """Qwen3-30B-A3B's port fields as the benchmark's configuration runs
    them (``servebench/configs``), cut to ``layers`` layers, widths kept."""
    from repro_torch.config import ModelConfig
    with open(QWEN3_MOE_FILE) as f:
        port = json.load(f)["low"]["port"]
    return ModelConfig(**port).replace(name=f"{port['name']}-L{layers}",
                                       num_layers=layers)


def moe_gemm_inputs(torch, T, skew, dtype, seed):
    """Tokens, Qwen3-30B-A3B's expert weights and a dropless routing of T
    tokens (even, or Zipf-like onto the low experts) packed as the MoE
    block packs it: rows in expert order, token order within an
    expert."""
    E, k, D, Fe = 128, 8, 2048, 768
    g = torch.Generator(device="cpu").manual_seed(seed)

    def w(*shape, fan):
        return (torch.randn(*shape, generator=g) / fan ** 0.5).to(
            "cuda", dtype)
    w1, w3, w2 = w(E, D, Fe, fan=D), w(E, D, Fe, fan=D), w(E, Fe, D, fan=Fe)
    x = torch.randn(T, D, generator=g).to("cuda", dtype)
    logits = torch.randn(T, E, generator=g)
    if skew:
        logits += 3.0 / (1.0 + torch.arange(E) / 4.0)
    idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :k]
    order = torch.argsort(idx.reshape(-1), stable=True)
    sizes = torch.bincount(idx.reshape(-1), minlength=E)
    offsets = torch.cat([sizes.new_zeros(1), sizes.cumsum(0)]).to(
        "cuda", torch.int32)
    return x, (order // k).cuda(), offsets, w1, w3, w2


def moe_grouped_phase(torch) -> dict:
    """(a) The grouped expert product's two CUDA kernels against their
    plain version (``ref.py``) at Qwen3-30B-A3B's widths (D 2048, F 768,
    E 128, k 8; T 512 and 4096, even and skewed routing; bf16, and fp32
    at T 512), timed beside their bound (every expert's weights and the
    entries' rows once), the plain loop, the padded path's three bmm at
    dropless capacity and torch's ``_grouped_mm`` (the library yardstick,
    which the port never calls); each built instance's registers, no
    spill. (b) Qwen3-30B-A3B cut to QWEN3_MOE_LAYERS layers at full width,
    served at the M.moe_fill cell's B2 S2048 as a ``SegmentedService``:
    each segment's replay equals its eager run bit for bit
    (``replay_check``), and the kernels' launches count exactly two a
    layer a call, eager, capturing and replayed."""
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gemm import kernel, ops, ref
    from repro_torch.models import api
    from repro_torch.models.segmentation import SegmentedService
    E, k, D, Fe = 128, 8, 2048, 768
    cases = {}
    for T, skew, name in MOE_GEMM_CASES:
        dtype = getattr(torch, name)
        x, src, off, w1, w3, w2 = moe_gemm_inputs(torch, T, skew, dtype,
                                                  seed=T + skew)
        out = ops.moe_grouped_ffn(x, src, off, w1, w3, w2)
        want = ref.moe_grouped_ffn_ref(x, src, off, w1, w3, w2)
        err = float((out.float() - want.float()).abs().max())
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        size = max(1.0, float(want.float().abs().max()))
        if not err <= tol * size:
            raise AssertionError(f"moe_grouped_ffn T{T} skew {skew} "
                                 f"{dtype}: error {err} of {size}")
        N, item = T * k, 2 if dtype == torch.bfloat16 else 4
        ops_ = 2 * N * D * 2 * Fe + 2 * N * Fe * D
        # every expert's weights, x once, H written and read, O written
        nbytes = item * (3 * E * D * Fe + T * D + 2 * N * Fe + N * D)
        bound, by = least_ms(nbytes, ops_, dtype_name(dtype))
        rec = {"max_abs_err": err, "bound_ms": bound, "bound_by": by,
               "ms": device_ms(torch, lambda: ops.moe_grouped_ffn(
                   x, src, off, w1, w3, w2), n=20),
               "max_group": int((off[1:] - off[:-1]).max())}
        t0 = time.perf_counter()
        ref.moe_grouped_ffn_ref(x, src, off, w1, w3, w2)
        torch.cuda.synchronize()
        rec["plain_ms"] = 1e3 * (time.perf_counter() - t0)
        if dtype == torch.bfloat16:
            # yardstick only: torch's grouped GEMM, gate|up as one weight
            w13 = torch.cat([w1, w3], dim=2).contiguous()
            ends = off[1:].contiguous()

            def library():
                gu = torch._grouped_mm(x[src], w13, offs=ends)
                h = (F.silu(gu[:, :Fe].float()) * gu[:, Fe:].float()
                     ).to(dtype)
                return torch._grouped_mm(h, w2, offs=ends)
            rec["library_ms"] = device_ms(torch, library, n=20)
        if T == 4096 and not skew:
            # the padded path's expert products at C = T: 16x the work
            buf = torch.randn(E, T, D, device="cuda", dtype=dtype)

            def padded():
                h = F.silu(torch.bmm(buf, w1).float()).to(dtype)
                return torch.bmm(h * torch.bmm(buf, w3), w2)
            rec["padded_ms"] = device_ms(torch, padded, n=2, reps=3)
            del buf
        cases[(T, skew, dtype_name(dtype))] = rec
        log(f"  moe_grouped_ffn T{T} {'skewed' if skew else 'even'} "
            f"{dtype_name(dtype)}: " + json.dumps(rec))
    log("  instances: " + json.dumps(kernel.instances()))

    cfg = qwen3_moe_config(QWEN3_MOE_LAYERS)
    model = api.build_params(cfg, seed=0, device="cuda")
    svc = SegmentedService(cfg, model, batch=2, seq=2048)
    batch = svc.make_input()
    n0 = ops.moe_grouped_ffn.launches
    state = batch
    for seg in svc.segments:                # eager run, capture, replay
        state = seg.fn(state)
    rec = {"replay": replay_check(torch, svc, batch)}
    rec["launches"] = ops.moe_grouped_ffn.launches - n0
    want = ops.KERNELS_A_CALL * cfg.num_layers * 3
    if rec["launches"] != want:
        raise AssertionError(f"{cfg.name}: {rec['launches']} grouped-"
                             f"product launches, {want} expected")
    log(f"  {cfg.name} B2 S2048: " + json.dumps(rec))
    del model, svc, state, batch
    free(torch)
    return {"cases": cases, "service": rec}


def moe_layer_grads(torch, lp, x, cfg, window, chunk, wy):
    """Gradients of sum(y * wy) + aux of one MoE layer with respect to
    each parameter and to x."""
    from repro_torch.models import moe
    names, params = zip(*lp.named_parameters())
    positions = torch.arange(x.shape[1], dtype=torch.int32, device="cuda")
    y, aux = moe.layer_apply(lp, x, positions, cfg, window=window,
                             chunk=chunk)
    scalar = (y.float() * wy).sum() + aux
    grads = torch.autograd.grad(scalar, params + (x,))
    return dict(zip(names + ("x",), grads))


def moe_train_check(torch, K):
    """Phase 4 (d): one full-width llama4 layer of each kind (chunked,
    then full) at B2 S2048: the gradients of a fixed scalar of the output
    (plus aux) with respect to every parameter and x, through the kernels
    (flash forward and backward launches exact), against the plain
    versions given the same expert choices, each within TRAIN_GRAD_TOL of
    its norm; then one full-width deepseek-v2 layer (MLA, no kernel): its
    gradients finite and non-zero. Each layer's peak memory is reported
    (MLA's four 512-row q blocks are checkpointed one by one)."""
    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention.kernel import BWD_PASSES
    from repro_torch.models import moe
    from repro_torch.models.layers import Maker
    recs = []
    for name, index in ((LLAMA4, 0), (LLAMA4, 3), (DEEPSEEK, 0)):
        t0 = time.perf_counter()
        cfg = get_config(name)
        window, chunk = moe.layer_kinds(cfg)[index]
        lp = moe.layer_build(Maker(0, torch.bfloat16, "cuda"), cfg, index)
        lp.requires_grad_(True)
        g = torch.Generator(device="cuda").manual_seed(index + 7)
        x = torch.randn(TRAIN_B, TRAIN_S, cfg.d_model, generator=g,
                        device="cuda").to(torch.bfloat16).requires_grad_()
        wy = torch.randn(x.shape, generator=g, device="cuda") / x.numel() ** 0.5
        label = f"{name} layer {index} (window {window}, chunk {chunk})"
        reset_launches(K)
        torch.cuda.reset_peak_memory_stats()
        with routed_as() as routing:
            grads = moe_layer_grads(torch, lp, x, cfg, window, chunk, wy)
        torch.cuda.synchronize()
        launches = read_launches(K)
        rec = {"model": label, "batch": TRAIN_B, "seq": TRAIN_S,
               "launches": launches,
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        for n, gr in grads.items():
            if not (bool(torch.isfinite(gr).all())
                    and float(gr.float().norm()) > 0):
                raise AssertionError(f"{label}: gradient of {n} is not "
                                     f"finite or is zero")
        need = {k: 0 for k in launches}
        if cfg.use_mla:
            rec["grad_tensors"] = len(grads)
            rec["grad_norms"] = {n: float(gr.float().norm())
                                 for n, gr in grads.items()}
        else:
            need.update(flash_attention=1,
                        flash_attention_bwd=BWD_PASSES[torch.bfloat16])
            with plain_versions(K), routed_as(routing) as forced:
                ref = moe_layer_grads(torch, lp, x, cfg, window, chunk, wy)
            rel = {n: float((grads[n].float() - r.float()).norm()
                            / r.float().norm()) for n, r in ref.items()}
            worst = max(rel, key=rel.get)
            rec.update(grad_tensors=len(rel), worst_grad=worst,
                       worst_grad_rel_err=rel[worst],
                       grad_rel_errs=rel,
                       tokens_rerouted_by_plain=forced["tokens_rerouted"])
            if not rel[worst] <= TRAIN_GRAD_TOL:
                raise AssertionError(f"{label}: gradient of {worst} off "
                                     f"by {rel[worst]} of its norm (tol "
                                     f"{TRAIN_GRAD_TOL})")
            del ref
        if launches != need:
            raise AssertionError(f"{label}: launches {launches}, need "
                                 f"{need}")
        rec["seconds"] = time.perf_counter() - t0
        log(f"  {label}: " + json.dumps(rec))
        recs.append(rec)
        del lp, x, grads
        free(torch)
    return recs


def moe_model_check(torch, K, name, batch, seq):
    """Phase 5 for a cut MoE model: finite logits of the right shape; for
    llama4, its first chunked and first full layer against the same layer
    on the plain versions (given the same expert choices) and two calls
    of a layer giving the same bits; for deepseek, which runs no kernel,
    its two forms: the last position's logits of prefill (S - 1 tokens)
    + one ``decode_step`` against ``forward`` over the same S tokens, the
    two given the same expert choices, with no entry dropped past an
    expert's capacity in either."""
    from repro_torch.config import get_config
    from repro_torch.models import api, moe
    from repro_torch.models import transformer as tfm
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = api.build_params(cfg, seed=0, device="cuda")
    tokens = api.make_batch(cfg, batch, seq, device="cuda")
    rec = {"model": name, "layers": cfg.num_layers, "batch": batch,
           "seq": seq}
    with torch.inference_mode():
        logits, aux = api.forward(model, tokens, cfg)
        if tuple(logits.shape) != (batch, seq, cfg.vocab_size) or not (
                bool(torch.isfinite(logits).all())
                and math.isfinite(float(aux))):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} "
                                 f"or aux {float(aux)} not finite")
        rec["aux"] = float(aux)
        del logits
        if not cfg.use_mla:
            x = tfm.embed_tokens(model, tokens, cfg)
            positions = tfm.positions_for(x)
            kinds = moe.layer_kinds(cfg)
            for i in (0, kinds.index((cfg.sliding_window, None))):
                window, chunk = kinds[i]

                def layer():
                    return moe.layer_apply(model.layers[i], x, positions,
                                           cfg, window=window, chunk=chunk)
                with routed_as() as routing:
                    y, _ = layer()
                again, _ = layer()
                with plain_versions(K), routed_as(routing) as forced:
                    y_ref, _ = layer()
                diff, scale = close_enough(f"{name} layer {i}", y, y_ref)
                rec[f"layer{i}"] = {
                    "window": window, "chunk": chunk,
                    "max_abs_diff": diff, "max_abs_out": scale,
                    "bitwise_repeat": bool(torch.equal(y, again)),
                    "tokens_rerouted_by_plain": forced["tokens_rerouted"]}
                if not rec[f"layer{i}"]["bitwise_repeat"]:
                    raise AssertionError(f"{name} layer {i}: two calls "
                                         f"gave different outputs")
        else:
            B, S = MOE_FORMS_B, MOE_FORMS_S
            toks = tokens[:B, :S]
            with routed_as() as routing, counted_drops() as drops:
                full, _ = api.forward(model, toks, cfg)
            L = cfg.num_layers
            by_pos = [i.view(B, S, -1) for i in routing["idx"]]
            given = ([i[:, :-1].reshape(B * (S - 1), -1) for i in by_pos]
                     + [i[:, -1] for i in by_pos])
            with routed_as(given) as forced, counted_drops() as drops2:
                _, caches = api.prefill(model, toks[:, :-1], cfg,
                                        extra_capacity=1)
                last, _ = api.decode_step(model, toks[:, -1:], S - 1,
                                          caches, cfg)
            want = full[:, -1:].float()
            rel = float((last.float() - want).abs().max()
                        / want.abs().max())
            rec["two_forms"] = {
                "batch": B, "seq": S, "rel_err": rel,
                "dropped": drops["dropped"] + drops2["dropped"],
                "calls": forced["calls"], "layers": L,
                "tokens_rerouted_by_decode_form":
                    forced["tokens_rerouted"]}
            if drops["dropped"] or drops2["dropped"]:
                raise AssertionError(f"{name}: entries dropped past "
                                     f"capacity in the two forms: "
                                     f"{rec['two_forms']}")
            if not rel <= MOE_FORMS_TOL:
                raise AssertionError(f"{name}: prefill + decode_step vs "
                                     f"forward, last position: {rel} of "
                                     f"max|logit| (tol {MOE_FORMS_TOL})")
            rec["mla_forms"] = mla_forms_check(torch, model, cfg)
    rec["seconds"] = time.perf_counter() - t0
    log(f"  {name}: " + json.dumps(rec))
    del model
    return rec


def mla_forms_check(torch, model, cfg) -> dict:
    """The first layer's MLA sublayer in its two forms, over the normed
    embeddings of random tokens: ``attn_prefill`` of the prompt then
    ``attn_apply_decode`` step by step (the cache path: the latent and
    rope key written to a ring, masked by slot position), against
    ``attn_apply_full`` over all the rows; each form's max |diff| within
    MLA_FORMS_TOL of max |full|."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm
    B, P, steps = MLA_FORMS_B, MLA_FORMS_PROMPT, MLA_FORMS_STEPS
    S = P + steps
    lp = model.layers[0]
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device="cuda")
    h = rms_norm(tfm.embed_tokens(model, tokens, cfg), lp.ln1, cfg.norm_eps)
    positions = tfm.positions_for(h)
    full = tfm.attn_apply_full(lp.attn, h, positions, cfg).float()
    y, cache = tfm.attn_prefill(lp.attn, h[:, :P], positions[:P], cfg, S)
    ys = [y]
    for t in range(P, S):
        y, cache = tfm.attn_apply_decode(lp.attn, h[:, t:t + 1], cache, t,
                                         cfg)
        ys.append(y)
    scale = float(full.abs().max())
    rec = {"batch": B, "prompt": P, "steps": steps, "max_abs_full": scale,
           "prefill_rel": float((ys[0].float() - full[:, :P]).abs().max())
           / scale,
           "decode_rel": float((torch.cat(ys[1:], 1).float()
                                - full[:, P:]).abs().max()) / scale}
    for form in ("prefill_rel", "decode_rel"):
        if not rec[form] <= MLA_FORMS_TOL:
            raise AssertionError(f"{cfg.name} MLA sublayer, {form}: "
                                 f"{rec[form]} of max|full| (tol "
                                 f"{MLA_FORMS_TOL}): {rec}")
    return rec


# ----------------------------------------------------- load and ops phases
def hi_layers() -> int:
    """qwen3-4b's layers: flash launches of one of its invocations (the
    mamba2 side of pair A launches none)."""
    from repro_torch.config import get_config
    return get_config(HI).num_layers


def load_capacity() -> dict:
    """serve_load's services (gold qwen3-4b B1 S32, bronze mamba2-2.7b B2
    S32) onboarded once: their mean measured JCTs and the request rate
    the card serves one at a time, 1 / (share·JCT_hi + (1-share)·JCT_lo),
    as ``benchmarks/bench_serving_load.py`` derives its rates."""
    from repro_torch.config import get_config
    from repro_torch.core.policy import Mode
    from repro_torch.serving import InferenceService, ServingSystem
    hi = InferenceService(get_config(HI), priority=0, batch=1, seq=32)
    lo = InferenceService(get_config(SSM_LO), priority=5, batch=2, seq=32)
    with ServingSystem(Mode.FIKIT, measure_runs=MEASURE_RUNS) as sys_:
        j_hi = statistics.mean(sys_.onboard(hi))
        j_lo = statistics.mean(sys_.onboard(lo))
    del hi, lo
    cap = 1.0 / (LOAD_SHARE * j_hi + (1 - LOAD_SHARE) * j_lo)
    return {"gold_jct_ms": 1e3 * j_hi, "bronze_jct_ms": 1e3 * j_lo,
            "capacity_rps": cap}


@contextlib.contextmanager
def recorded_planes():
    """Every admission plane the engine builds keeps its event log (the
    ``admit`` events count the groups the engine ran); yields the list
    the planes land in."""
    from repro_torch.serving import engine
    planes = []

    class Recording(engine.AdmissionPlane):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, record_events=True))
            planes.append(self)
    with mock.patch.object(engine, "AdmissionPlane", Recording):
        yield planes


def load_run(torch, K, mode, factor, seconds, cap):
    """The ``load`` path: serve_load of pair A at full size under ``mode``
    at ``factor`` × the capacity, with every launch counter set to 0
    before it and read after it. Fails on a FAILED ticket, a priority
    inversion, a class that breaks the plane's invariant, a flash count
    other than 36 per qwen3 invocation the engine ran, or no gold
    completion at half the capacity."""
    from repro_torch.launch.serve import serve_load
    rate = factor * cap["capacity_rps"]
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    with recorded_planes() as planes:
        reset_launches(K)
        t0 = time.perf_counter()
        out = serve_load(HI, SSM_LO, mode=mode, rate=rate, duration=seconds,
                         hi_share=LOAD_SHARE, deadline=LOAD_DEADLINE,
                         diurnal=True, measure_runs=MEASURE_RUNS,
                         seed=LOAD_SEED, reduced=False, device="cuda",
                         verbose=False)
        launches = read_launches(K)
        wall = time.perf_counter() - t0
    (plane,) = planes
    peak = torch.cuda.max_memory_allocated()
    st = plane.stats()
    admits = [e for e in plane.events if e[1] == "admit"]
    # the plane holds its system, whose engine holds every kernel's
    # request and with it the models
    del plane, planes
    free(torch)
    groups = {c: sum(1 for e in admits if e[2] == c) for c in st["classes"]}
    classes = {c: {k: s[k] for k in (
        "offered", "admitted", "completed", "rejected", "shed", "requeued",
        "failed", "cancelled", "p50_ms", "p99_ms", "mean_ms", "goodput")}
        for c, s in st["classes"].items()}
    for c in classes:
        classes[c]["groups"] = groups[c]
        classes[c]["mean_group"] = (classes[c]["admitted"] / groups[c]
                                    if groups[c] else 0.0)
    rec = {"mode": mode, "factor": factor, "rate_rps": rate,
           "schedule_s": seconds, "offered": out["offered"],
           "feeder_lag_max_ms": out["feeder_lag_max_ms"],
           "priority_inversions": st["priority_inversions"],
           "classes": classes, "launches": launches,
           "peak_mem_bytes": peak, "wall_s": wall}
    log(f"  {mode} {factor}x: " + json.dumps(rec))
    bad = []
    for c, s in classes.items():
        if s["failed"]:
            bad.append(f"{c}: {s['failed']} FAILED tickets")
        if s["offered"] != (s["admitted"] + s["rejected"] + s["shed"]
                            + s["requeued"]):
            bad.append(f"{c}: offered != admitted + rejected + shed + "
                       f"requeued")
        if s["admitted"] != s["completed"] + s["failed"] + s["cancelled"]:
            bad.append(f"{c}: admitted != completed + failed + cancelled")
    if st["priority_inversions"] or any(e[4] for e in admits):
        bad.append(f"{st['priority_inversions']} priority inversions")
    need = hi_layers() * (1 + MEASURE_RUNS + groups["gold"])
    if launches["flash_attention"] != need:
        bad.append(f"flash launches {launches['flash_attention']}, the "
                   f"run's {groups['gold']} gold groups need exactly {need}")
    if factor <= 0.5 and not classes["gold"]["completed"]:
        bad.append("no gold completion at half the capacity")
    if bad:
        raise AssertionError(f"load {mode} {factor}x: " + "; ".join(bad))
    return rec


@contextlib.contextmanager
def kept_systems():
    """Every ServingSystem that stops is kept (with its engine's record of
    each kernel's start and end); yields the list."""
    from repro_torch.serving import engine
    kept = []
    real_stop = engine.ServingSystem.stop

    def stop(self):
        kept.append(self)
        real_stop(self)
    with mock.patch.object(engine.ServingSystem, "stop", stop):
        yield kept


@contextlib.contextmanager
def timed_records():
    """Times every write-ahead completion record the store commits; yields
    the list of their durations (s)."""
    from repro_torch.core.jobstore import JobStore
    times = []
    real = JobStore.record_completion

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real(self, *a, **kw)
        finally:
            times.append(time.perf_counter() - t0)
    with mock.patch.object(JobStore, "record_completion", timed):
        yield times


def sharing_sk_sg(sys_, key, kind="layer") -> dict:
    """Sharing-phase SK (a kernel's start to end) and SG (its end to the
    next kernel's start of the same invocation) of ``key``'s ``kind``
    segments, from the engine's record of every kernel it ran."""
    runs = {}
    for r in sys_.engine.records():
        if r.req.task_key == key:
            runs.setdefault(r.req.task_instance, []).append(r)
    sk, sg = [], []
    for recs in runs.values():
        recs.sort(key=lambda r: r.req.seq_index)
        for a, b in zip(recs, recs[1:] + [None]):
            if a.req.kernel_id.name.endswith("/" + kind):
                sk.append(a.end - a.start)
                if b is not None:
                    sg.append(b.start - a.end)
    return {"SK_ms": 1e3 * statistics.mean(sk),
            "SG_ms": 1e3 * statistics.mean(sg), "segments": len(sk)}


def ops_pair(torch, K, jobstore):
    """Pair A's serve_pair at full size under FIKIT, with or without the
    ops plane's store: hi JCT, qwen3's sharing-phase layer SK/SG and the
    time of each write-ahead record."""
    from repro_torch.config import get_config
    from repro_torch.core.task import TaskKey
    from repro_torch.launch.serve import serve_pair
    with kept_systems() as kept, timed_records() as rec_times:
        reset_launches(K)
        out = serve_pair(HI, SSM_LO, mode="fikit", reduced=False,
                         device="cuda", requests=REQUESTS,
                         measure_runs=MEASURE_RUNS, jobstore=jobstore,
                         verbose=False)
        launches = read_launches(K)
    (sys_,) = kept
    hi = sharing_sk_sg(sys_, TaskKey(get_config(HI).name, (2, 48)))
    lo = sharing_sk_sg(sys_, TaskKey(get_config(SSM_LO).name, (4, 48)))
    del kept, sys_
    free(torch)
    rec = {"jobstore": jobstore is not None,
           "high_jct_ms": out["high_jct_ms"], "low_jct_ms": out["low_jct_ms"],
           "fills": out["fills"], "qwen3_layer_sharing": hi,
           "mamba2_layer_sharing": lo, "launches": launches,
           "records": len(rec_times)}
    if rec_times:
        srt = sorted(rec_times)
        rec["record_ms"] = {"mean": 1e3 * statistics.mean(srt),
                            "p50": 1e3 * srt[len(srt) // 2],
                            "max": 1e3 * srt[-1]}
    log("  serve_pair " + ("with" if jobstore else "without")
        + " jobstore: " + json.dumps(rec))
    need = hi_layers() * (1 + MEASURE_RUNS + REQUESTS)
    if launches["flash_attention"] != need:
        raise AssertionError(f"ops serve_pair: flash launches "
                             f"{launches['flash_attention']}, need {need}")
    if jobstore is not None:
        # every segment of the served requests, qwen3's and mamba2's
        want = (n_segments(HI) + n_segments(SSM_LO)) * REQUESTS
        if len(rec_times) != want:
            raise AssertionError(f"{len(rec_times)} write-ahead records, "
                                 f"the served requests have {want} kernels")
    return rec


def n_segments(name) -> int:
    """Segments of one invocation of a dense or SSM model: embed, one a
    layer, head."""
    from repro_torch.config import get_config
    return get_config(name).num_layers + 2


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _held_at(svc, at):
    """Hold ``svc``'s segment ``at`` until released: returns (entered,
    release, undo)."""
    import threading
    seg = svc.svc.segments[at]
    body = seg.fn
    entered, release = threading.Event(), threading.Event()

    def fn(state):
        entered.set()
        release.wait(60)
        return body(state)
    seg.fn = fn

    def undo():
        release.set()
        seg.fn = body
    return entered, release, undo


def device_bytes(torch, sys_) -> int:
    """Device memory allocated by live tensors once the engine lets go of
    the last kernels it ran: a no-op kernel goes through the engine first
    (its device thread keeps the last kernel's request and output until
    the next one arrives), then the record of finished kernels is cleared
    (each record keeps its request, whose payload holds the segment's
    input)."""
    from repro_torch.core.client import HookClient, Segment
    from repro_torch.core.task import TaskKey
    noop = Segment("flush/noop", lambda state: None)
    HookClient(sys_.engine, TaskKey("flush"), 9, [noop],
               identify=False).run(None)
    gc.collect()
    with sys_.engine._lock:
        sys_.engine._records.clear()
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def ops_verbs(torch, K, db):
    """One full-width qwen3-4b service under a ServingSystem with the
    store at ``db``: an uninterrupted invocation, one paused at segment
    OPS_AT and resumed through control rows the poller consumes (its
    tokens must equal the first's), and one cancelled there (its memory
    must come back)."""
    import threading
    from repro_torch.config import get_config
    from repro_torch.core import jobstore as js
    from repro_torch.core.policy import Mode
    from repro_torch.serving import InferenceService, ServingSystem
    hi = InferenceService(get_config(HI), priority=0, batch=2, seq=48,
                          host_gap=0.002)
    rec = {}
    with js.JobStore(db) as cli, ServingSystem(
            Mode.FIKIT, measure_runs=MEASURE_RUNS, jobstore=db) as sys_:
        sys_.onboard(hi)
        # keep the sampled tokens of each invocation from here on
        head = hi.svc.segments[-1]
        sample, toks = head.host_work, []
        head.host_work = lambda x: (toks.append(sample(x)), toks[-1])[1]
        reset_launches(K)
        rec["uninterrupted_jct_ms"] = 1e3 * sys_.invoke(hi)[0]

        def running():
            jobs = cli.jobs(states=(js.RUNNING,))
            return jobs[-1].job_id if jobs else None

        # pause, then resume
        entered, release, undo = _held_at(hi, OPS_AT)
        before = device_bytes(torch, sys_)
        out = {}
        th = threading.Thread(target=lambda: out.update(
            jcts=sys_.invoke(hi)))
        th.start()
        try:
            _wait(entered.is_set, "the held segment")
            job = running()
            cli.request_control("pause", job)
            _wait(lambda: cli.job(job).state == js.PAUSED, "PAUSED")
            release.set()
            time.sleep(0.3)
            held = cli.job(job).completed
            rec["paused_bytes"] = device_bytes(torch, sys_) - before
            time.sleep(0.2)
            if cli.job(job).completed != held:
                raise AssertionError("a paused invocation kept running")
            cli.request_control("resume", job)
            th.join(60)
        finally:
            undo()
        if th.is_alive() or cli.job(job).state != js.DONE:
            raise AssertionError(f"paused job {job} did not finish DONE")
        rec["paused_watermark"] = held
        rec["paused_resumed_jct_ms"] = 1e3 * out["jcts"][0]
        rec["tokens_equal"] = bool(len(toks) == 2
                                   and (toks[0] == toks[1]).all())
        if held != OPS_AT + 1 or not rec["tokens_equal"]:
            raise AssertionError(f"pause/resume: watermark {held} (want "
                                 f"{OPS_AT + 1}), tokens equal "
                                 f"{rec['tokens_equal']}")

        # cancel
        entered, release, undo = _held_at(hi, OPS_AT)
        before = device_bytes(torch, sys_)
        th = threading.Thread(target=lambda: out.update(
            jcts=sys_.invoke(hi)))
        th.start()
        try:
            _wait(entered.is_set, "the held segment")
            job = running()
            cli.request_control("cancel", job)
            _wait(lambda: cli.job(job).state == js.CANCELLED, "CANCELLED")
            release.set()
            th.join(60)
        finally:
            undo()
        after = device_bytes(torch, sys_)
        rec["cancelled_jcts"] = out["jcts"]
        rec["cancelled_watermark"] = cli.job(job).completed
        rec["cancelled_invocations"] = sys_.cancelled_invocations
        rec["bytes_before_cancel"], rec["bytes_after_cancel"] = before, after
        launches = read_launches(K)
        rec["launches"] = launches
        status = sys_.status()
        rec["rejected_controls"] = status["rejected_controls"]
        rec["poller_deaths"] = status["poller_deaths"]
    log("  pause/resume/cancel: " + json.dumps(rec))
    del hi, toks
    free(torch)
    if (out["jcts"] or rec["cancelled_invocations"] != 1
            or rec["cancelled_watermark"] != OPS_AT + 1 or after != before):
        raise AssertionError(f"cancel: {rec}")
    # two whole invocations, and the cancelled one's layers before OPS_AT
    need = 2 * hi_layers() + OPS_AT
    if launches["flash_attention"] != need:
        raise AssertionError(f"ops verbs: flash launches {launches}, need "
                             f"{need}")
    if rec["rejected_controls"] or rec["poller_deaths"]:
        raise AssertionError(f"ops verbs: poller {status}")
    return rec


def ops_recover(torch, K, db):
    """A RUNNING row left in the store, as a killed run leaves it, re-run
    to DONE by ``serve_pair(..., resume=True)``; then the ``status`` verb,
    run as a subprocess, lists every job of the store DONE or
    CANCELLED."""
    from repro_torch.config import get_config
    from repro_torch.core import jobstore as js
    from repro_torch.core.task import TaskKey
    from repro_torch.launch.serve import serve_pair
    n_kernels = n_segments(HI)
    with js.JobStore(db) as store:
        key = TaskKey(get_config(HI).name, (2, 48))
        job = store.record_submit(None, key, 0, n_kernels=n_kernels,
                                  state=js.RUNNING)
        for seq in range(5):
            store.record_completion(job, seq)
    reset_launches(K)
    out = serve_pair(HI, SSM_LO, mode="fikit", reduced=False, device="cuda",
                     requests=1, measure_runs=1, jobstore=db, resume=True,
                     verbose=False)
    launches = read_launches(K)
    free(torch)
    with js.JobStore(db) as store:
        row = store.job(job)
        rows = [(j.job_id, j.key.process, j.state) for j in store.jobs()]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "status",
         "--jobstore", db], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    listed = [line.split() for line in res.stdout.splitlines()[1:]]
    states = sorted({cols[3] for cols in listed})
    rec = {"recovered_jobs": out["recovered_jobs"], "job": job,
           "state": row.state, "completed": row.completed,
           "launches": launches, "status_rc": res.returncode,
           "status_jobs": len(listed), "store_jobs": len(rows),
           "status_states": states}
    log("  recover + status: " + json.dumps(rec))
    print(res.stdout, end="", flush=True)
    # warm-up, one measured run, the recovered job and one request
    need = hi_layers() * 4
    bad = (out["recovered_jobs"] != 1 or row.state != js.DONE
           or row.completed != n_kernels or res.returncode != 0
           or len(listed) != len(rows)
           or not set(states) <= {js.DONE, js.CANCELLED}
           or launches["flash_attention"] != need)
    if bad:
        raise AssertionError(f"recover/status: {rec}; stderr "
                             f"{res.stderr[-2000:]}; need flash {need}")
    return rec


# the instances the build phase checks in each library: the kernel's
# mangled name, how to label an instance, the SASS opcode it must show
# (None: no tensor cores), how many instances there are, and whether a
# spill fails the build. flash and decode: their bf16 tensor-core
# instances; the grouped expert product: its bf16 (wgmma) and fp32
# kernels; rglru_scan and its backward: both of their own (fp32,
# bf16); flash's backward: its bf16 instances (dQ at D 64, 96, 120, 128 x
# 1 or 2 warpgroups and D 256 x 1; dK/dV at the 5 head dims), then its
# fp32 ones (3 passes x 5 head dims, CUDA cores), whose spills are
# reported
INSTANCES = {
    "flash_attention": (r"flash_fwd_tcILi(\d+)ELi(\d+)E",
                        lambda t: f"D{t.group(1)} x{t.group(2)} warpgroups",
                        "HGMMA", 10, True),
    "decode_attention": (r"decode_split_tcILi(\d+)E",
                         lambda t: f"D{t.group(1)}", "HMMA", 4, True),
    "rglru_scan": (r"rglru_scan_splitI(f|13__nv_bfloat16)E",
                   lambda t: "fp32" if t.group(1) == "f" else "bf16",
                   None, 2, True),
    "flash_attention_bwd": (
        r"flash_bwd_(dq|dkdv)_tcILi(\d+)E(?:Li(\d+)E)?",
        lambda t: (f"{t.group(1)} bf16 D{t.group(2)}"
                   + (f" x{t.group(3)} warpgroups" if t.group(3) else "")),
        "HGMMA", 14, True),
    "flash_attention_bwd fp32": (
        r"(flash_bwd_(?:stats|dkdv|dq))IfLi(\d+)E",
        lambda t: f"{t.group(1)} fp32 D{t.group(2)}", None, 15, False),
    "rglru_scan_bwd": (r"rglru_scan_bwd_splitI(f|13__nv_bfloat16)E",
                       lambda t: "fp32" if t.group(1) == "f" else "bf16",
                       None, 2, True),
    "moe_grouped_gemm": (r"2tc\d+moe_grouped_(gate_up|down)",
                         lambda t: t.group(1), "HGMMA", 2, True),
    "moe_grouped_gemm fp32": (r"4simt\d+moe_grouped_(gate_up|down)",
                              lambda t: t.group(1), None, 2, True),
}


def instance_check(lib, kernel: str) -> dict:
    """The checked instances ``kernel`` (an ``INSTANCES`` key) in the
    built library: registers and spill bytes from ptxas's ``-v`` report
    beside it, and the count of its tensor-core instruction (flash and
    its bf16 backward: HGMMA, wgmma; decode: HMMA, mma.sync) in
    ``cuobjdump -sass``. Fails if an instance is missing, spills where
    that fails the build, or has no tensor-core instruction where one is
    expected."""
    pattern, label, opcode, expect, spill_fails = INSTANCES[kernel]

    def instance(symbol):
        t = re.search(pattern, symbol)
        return label(t) if t else None
    inst = {}
    name = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = instance(m.group(1))
            if name:
                inst[name] = {"registers": None, "spill_bytes": 0}
                if opcode:
                    inst[name][opcode.lower()] = 0
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            inst[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            inst[name]["registers"] = int(m.group(1))
    bad = {k: v for k, v in inst.items()
           if v["spill_bytes"] and spill_fails}
    if opcode is None:
        if len(inst) != expect or bad:
            raise AssertionError(f"{kernel} instances {inst}: expected "
                                 f"{expect}, none with spills")
        return inst
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = instance(m.group(1))
        elif name in inst and re.search(rf"\b{opcode}\b", line):
            inst[name][opcode.lower()] += 1
    bad = {k: v for k, v in inst.items()
           if v["spill_bytes"] or not v[opcode.lower()]}
    if len(inst) != expect or bad:
        raise AssertionError(f"{kernel} instances {inst}: expected "
                             f"{expect}, each with {opcode} and no spills")
    return inst


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def kernel_entry(name, source, replaces, launches, rec, shape):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches},
                **{k: rec[k] for k in keys + ("plan",) if k in rec},
                shape=shape)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    register_moe_cuts()
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.flash_attention import ref as fl_ref
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    K = {"flash_attention": (fl_ops, fl_ref),
         "decode_attention": (dec_ops, dec_ref),
         "rglru_scan": (rg_ops, rg_ref)}
    K["launchers"] = launchers(K)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    sources = KERNELS + BWD_SOURCES + MOE_SOURCES
    libs = _build.build_all(sources)
    log(f"[build] {', '.join(k + '.cu' for k in sources)} "
        f"built with nvcc for sm_90a in {time.perf_counter() - t0:.1f} s "
        f"(in parallel)")
    for name, (_, _, opcode, _, spill_fails) in INSTANCES.items():
        what = "bf16 instances (tensor cores)" if opcode else "instances"
        if not spill_fails:
            what += " (a spill is reported, not failed)"
        lib = libs[name.split()[0]]
        log(f"  {name} {what}: " + json.dumps(instance_check(lib, name)))

    bf16, f32 = torch.bfloat16, torch.float32
    seed = 0
    log("[kernels] flash_attention vs its plain version")
    fl = {}
    for case in TEST_CASES + EDGE_CASES + [HI_SHAPE, LO_SHAPE, HYB_SHAPE,
                                           GRANITE_SHAPE, RAGGED,
                                           ALL_MASKED]:
        for dtype in (f32, bf16):
            seed += 1
            fl[(case[:6], dtype)] = check_flash_case(torch, K, case, dtype,
                                                     seed)
    # the paths' own layout: attend's transposed [B, S, H, D] views
    for case in (HI_SHAPE, LO_SHAPE, HYB_SHAPE, GRANITE_SHAPE):
        for dtype in (f32, bf16):
            seed += 1
            fl[("path", case[:6], dtype)] = check_flash_case(
                torch, K, case, dtype, seed, path_layout=True)
    fl["hi_prompt"] = check_flash_case(torch, K, HI_PROMPT, bf16, seed + 1,
                                       path_layout=True)
    fl["prompt"] = check_flash_case(torch, K, HYB_PROMPT, bf16, seed + 2,
                                    path_layout=True)
    fl["prompt_bhsd"] = check_flash_case(torch, K, HYB_PROMPT, bf16,
                                         seed + 3)
    fl["long"] = check_flash_case(torch, K, LONG, bf16, seed + 4)
    seed += 4
    # this slice's paths, in their own layout; D 128 at h2o's shapes
    for case in (H2O_SHAPE, CROSS_48, CROSS_1):
        for dtype in (f32, bf16):
            seed += 1
            fl[("path", case[:6], dtype)] = check_flash_case(
                torch, K, case, dtype, seed, path_layout=True)
    for case in [H2O_PROMPT, ENCODER, LLAVA_SHAPE] + D128_AT_H2O:
        seed += 1
        fl[("path", case[:6], bf16)] = check_flash_case(
            torch, K, case, bf16, seed, path_layout=True)
    # llama4-scout's (G 5): serving in its chunked and full layers, and
    # the generate phase's prompt across the 8192 chunk, both kinds
    for case in (L4_SERVE, L4_SERVE_FULL):
        for dtype in (f32, bf16):
            seed += 1
            fl[("path", case[:6], str(case[6]), dtype)] = check_flash_case(
                torch, K, case, dtype, seed, path_layout=True)
    for case in (L4_PROMPT, L4_PROMPT_FULL):
        seed += 1
        fl[("path", case[:6], str(case[6]), bf16)] = check_flash_case(
            torch, K, case, bf16, seed, path_layout=True)
        free(torch)

    log("[kernels] decode_attention vs its plain version")
    dec = {}
    for case in DECODE_CASES + DEC_EDGE + [DEC_HI, DEC_HYB, DEC_MASKED]:
        for dtype in (f32, bf16):
            seed += 1
            dec[(case[:5], str(case[5]), dtype)] = check_decode_case(
                torch, K, case, dtype, seed)
    for dtype in (f32, bf16):
        seed += 1
        dec[("ring", dtype)] = check_decode_case(torch, K, RING_CASE, dtype,
                                                 seed, empty_from=100)
    dec["long"] = check_decode_case(torch, K, DEC_LONG, bf16, seed + 1)
    seed += 1
    for case in (DEC_H2O, DEC_SEAMLESS, DEC_LLAVA):
        for dtype in (f32, bf16):
            seed += 1
            dec[(case[:5], dtype)] = check_decode_case(torch, K, case, dtype,
                                                       seed)
    seed += 1
    dec[(DEC_H2O_D128[:5], bf16)] = check_decode_case(
        torch, K, DEC_H2O_D128, bf16, seed)
    for case in (DEC_L4, DEC_L4_FULL):        # llama4's wrapped 8192 ring
        seed += 1
        dec[(case[:5], str(case[5]), bf16)] = check_decode_case(
            torch, K, case, bf16, seed)

    log("[kernels] rglru_scan vs its plain version")
    rg = {}
    for case in RGLRU_CASES + [RG_SERVE, RG_PREFILL] + RG_EDGE + [RG_LONG]:
        seed += 1
        rg[case] = check_rglru_case(torch, K, case, f32, seed)
    rg["no_h0"] = check_rglru_case(torch, K, RG_SERVE, f32, seed + 1,
                                   with_h0=False)
    rg["bf16"] = check_rglru_case(torch, K, RG_SERVE, bf16, seed + 2)
    rg["prompt_no_h0"] = check_rglru_case(torch, K, RG_PREFILL, f32,
                                          seed + 3, with_h0=False)
    rg["prompt_bf16"] = check_rglru_case(torch, K, RG_PREFILL, bf16,
                                         seed + 4)
    seed += 4
    free(torch)

    log("[kernels] backward kernels vs autograd of their plain versions")
    bwd = {}
    for case in FLASH_BWD_CASES:
        for dtype in (f32, bf16):
            seed += 1
            bwd[(case[:6], dtype)] = check_flash_bwd_case(torch, K, case,
                                                          dtype, seed)
            free(torch)
    for case in (L4_TRAIN, L4_SPLIT5):        # llama4's G 5, bf16
        seed += 1
        bwd[(case[:6], bf16)] = check_flash_bwd_case(torch, K, case, bf16,
                                                     seed)
        free(torch)
    for case in RG_BWD_CASES:
        for with_h0 in (True, False):
            seed += 1
            bwd[(case, with_h0)] = check_rglru_bwd_case(
                torch, K, case, f32, seed, with_h0)
    for with_h0 in (True, False):
        seed += 1
        bwd[(RG_TRAIN, with_h0, "bf16")] = check_rglru_bwd_case(
            torch, K, RG_TRAIN, bf16, seed, with_h0)
    free(torch)

    log("[train] (a) qwen3-4b at full width, 2 layers, and (c) "
        "recurrentgemma-9b at full width, one (rec, rec, attn) pattern: "
        "one step's gradients, kernels vs plain versions")
    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention.kernel import BWD_PASSES
    bwd_bf16 = BWD_PASSES[bf16]
    train_grads_check(
        torch, K, "qwen3-4b (2 layers)",
        get_config(HI).replace(num_layers=2), TRAIN_B, TRAIN_S,
        {"flash_attention": 2 * 2, "flash_attention_bwd": 2 * bwd_bf16,
         "decode_attention": 0, "rglru_scan": 0, "rglru_scan_bwd": 0})
    free(torch)
    train_hyb = train_grads_check(
        torch, K, "recurrentgemma-9b (rec, rec, attn)",
        get_config(HYB).replace(num_layers=3), TRAIN_B, HYB_TRAIN_S,
        {"flash_attention": 2, "flash_attention_bwd": bwd_bf16,
         "rglru_scan": 2 * 2, "rglru_scan_bwd": 2, "decode_attention": 0},
        timed=True)
    free(torch)
    log(f"[train] (b) qwen3-4b at full width and depth: {TRAIN_STEPS} "
        f"steps of launch.train.train, B{TRAIN_B} S{TRAIN_S}")
    train_qwen = train_full(torch, K)
    free(torch)
    log(f"[train] (d) one full-width layer of {LLAMA4} of each kind "
        f"(chunked, full) and one of {DEEPSEEK}, B{TRAIN_B} S{TRAIN_S}: "
        f"gradients of a scalar of the output plus aux")
    train_moe = moe_train_check(torch, K)

    log("[model] full-size models, kernels vs plain versions in a block "
        "of each kind")
    model_check(torch, K, HI, 2, 48)
    free(torch)
    model_check(torch, K, LO, 4, 48)
    free(torch)
    model_check(torch, K, GRANITE, 4, 48)
    free(torch)
    ssm_model = model_check(torch, K, SSM_LO, 4, 48, keep=True)
    free(torch)
    hyb_model = model_check(torch, K, HYB, 4, 48, keep=True)
    free(torch)
    for name, batch in ((H2O, 4), (SEAMLESS, 2), (LLAVA, 4)):
        model_check(torch, K, name, batch, 48)   # pairs F and J's shapes
        free(torch)
    for name in (LLAMA4_L8, DEEPSEEK_L6):        # pairs H and D, high
        moe_model_check(torch, K, name, 2, 48)
        free(torch)

    log(f"[generate] prefill + {GEN_STEPS} decode steps, kernels vs plain "
        f"versions at every step")
    # the hybrid's end-to-end logits are compared but not held: its random
    # MQA keys are not scaled down (the JAX init's fan_in is Kh = 1), its
    # attention logits reach a few thousand and the softmax is near one-hot,
    # so a one-ulp bf16 difference in any block can flip a row's argmax key
    # and the two runs drift apart with depth and length, while each
    # kernel call stays within one ulp of its plain version (held below)
    ((_, hyb_batch, hyb_prompt), (_, hi_batch, hi_prompt),
     (_, ssm_batch, ssm_prompt)) = GENERATE
    gen_hyb = generate_check(torch, K, HYB, hyb_model, hyb_batch, hyb_prompt,
                             hold_logits=False)
    del hyb_model
    free(torch)
    gen_hi = generate_check(torch, K, HI, None, hi_batch, hi_prompt,
                            hold_logits=True)
    free(torch)
    # no kernel on mamba2's path: its three runs are one function, and its
    # attention kernels' launches must be 0
    generate_check(torch, K, SSM_LO, ssm_model, ssm_batch, ssm_prompt,
                   hold_logits=True)
    del ssm_model
    free(torch)
    # h2o-danube, seamless and llava at the reference init are chaotic as
    # the hybrid is (see rescale_qk); with wq and wk at fan_in d_model
    # they are not, and their end-to-end logits are held at every step
    gen = {}
    for name, batch, prompt in GENERATE_NEW:
        gen[name] = generate_check(torch, K, name, None, batch, prompt,
                                   hold_logits=True, rescale=True)
        free(torch)
    for name, batch, prompt, rescale in MOE_GENERATE:
        gen[name] = generate_check(torch, K, name, None, batch, prompt,
                                   hold_logits=True, rescale=rescale)
        free(torch)
    log("[moe_gemm] the grouped expert product at Qwen3-30B-A3B's widths "
        "and its service's replays")
    moe_gemm = moe_grouped_phase(torch)

    served = {}
    for high, low in PAIRS + MOE_PAIRS:
        log(f"[serve] serve_pair({high!r}, {low!r}, reduced=False, "
            f"requests={REQUESTS}, measure_runs={MEASURE_RUNS})")
        fikit = serve_run(torch, K, high, low, "fikit")
        sharing = serve_run(torch, K, high, low, "sharing")
        served[(high, low)] = fikit
        log(f"  high-priority JCT: FIKIT {fikit['high_jct_ms']:.3f} ms vs "
            f"SHARING {sharing['high_jct_ms']:.3f} ms (ratio "
            f"{fikit['high_jct_ms'] / sharing['high_jct_ms']:.3f}); low: "
            f"FIKIT {fikit['low_jct_ms']:.3f} ms vs SHARING "
            f"{sharing['low_jct_ms']:.3f} ms; fills {fikit['fills']}; "
            f"peak memory FIKIT {fikit['peak_mem_bytes'] / 2**30:.1f} GiB, "
            f"SHARING {sharing['peak_mem_bytes'] / 2**30:.1f} GiB")

    for high, low in PAIRS + MOE_PAIRS:
        log(f"[profile] {high} + {low}, measurement phase: SK/SG per "
            f"segment, one block's device time")
        segment_profile(torch, high, low)

    log(f"[load] serve_load({HI!r}, {SSM_LO!r}, reduced=False): open-loop "
        f"Poisson gold + diurnal bronze through the admission plane")
    cap = load_capacity()
    free(torch)
    log("  capacity from the measurement phase: " + json.dumps(cap))
    for mode, factor, seconds in LOAD_RUNS:
        load_run(torch, K, mode, factor, seconds, cap)

    log(f"[ops] serve_pair({HI!r}, {SSM_LO!r}, reduced=False) without and "
        f"with jobstore={os.path.relpath(OPS_DB, ROOT)!r}; pause, resume, "
        f"cancel, recover, status")
    os.makedirs(os.path.dirname(OPS_DB), exist_ok=True)
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(OPS_DB + suffix):
            os.remove(OPS_DB + suffix)
    for store in (None, OPS_DB, OPS_DB, None):   # in turns
        ops_pair(torch, K, store)
    ops_verbs(torch, K, OPS_DB)
    ops_recover(torch, K, OPS_DB)

    log("[mesh] the make_*_step functions under the (1, 1) host mesh: (b) "
        f"qwen3-4b (2 layers) train B{TRAIN_B} S{TRAIN_S}, (c) qwen3-4b "
        f"prefill + {GEN_STEPS} serve steps, (d) {LLAMA4_L4} prefill, "
        "(e) the meshed full-depth step beside phase 4 (b)'s un-meshed "
        "train()")
    mesh_phase(torch, K, train_qwen, smi)

    pair_e = served[(HI, HYB)]["launches"]

    def flash_launches(pair, case):
        """flash launches at ``case``'s shape in the FIKIT serve_pair run
        of ``pair`` (high, low)."""
        return served[pair]["flash_launches_by_shape"].get(shape_key(case),
                                                           0)
    entries = [
        kernel_entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:79",
            flash_launches((HI, HYB), HI_SHAPE), fl[("path", HI_SHAPE[:6], bf16)],
            "B2 H32 Kh8 S48 D128 bf16 (qwen3-4b serving, attend's "
            "transposed views); launches: at this shape, one FIKIT "
            "serve_pair run of pair E"),
        kernel_entry(
            "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:71",
            gen_hi["launches"]["decode_attention"],
            dec[(DEC_HI[:5], "{}", bf16)],
            "B2 H32 Kh8 C1040 D128 bf16 (qwen3-4b generation); launches: "
            f"qwen3-4b generate, {GEN_STEPS} steps"),
        kernel_entry(
            "rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
            "src/repro/kernels/rglru_scan/kernel.py:40",
            pair_e["rglru_scan"], rg[RG_SERVE],
            "B4 S48 W4096 fp32 (recurrentgemma-9b serving); launches: one "
            "FIKIT serve_pair run of pair E"),
        kernel_entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:79",
            flash_launches((LO, H2O), H2O_SHAPE),
            fl[("path", H2O_SHAPE[:6], bf16)],
            "B4 H32 Kh8 S48 D120 bf16 (h2o-danube-3-4b serving, the D 120 "
            "instance); launches: at this shape, one FIKIT serve_pair run "
            "of pair F"),
        kernel_entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:79",
            flash_launches((SEAMLESS, LLAVA), LLAVA_SHAPE),
            fl[("path", LLAVA_SHAPE[:6], bf16)],
            "B4 H32 Kh8 S2881 D128 bf16 (llava-next-mistral-7b serving); "
            "launches: at this shape, one FIKIT serve_pair run of pair J"),
        kernel_entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:79",
            flash_launches((SEAMLESS, LLAVA), CROSS_48),
            fl[("path", CROSS_48[:6], bf16)],
            "B2 H16 Sq48 Sk1024 D64 non-causal bf16 (seamless-m4t-medium "
            "cross-attention, serving); launches: at this shape, one FIKIT "
            "serve_pair run of pair J"),
        kernel_entry(
            "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:71",
            gen[H2O]["launches"]["decode_attention"],
            dec[(DEC_H2O[:5], bf16)],
            "B2 H32 Kh8 C4096 D120 bf16 wrapped ring (h2o-danube-3-4b "
            f"generation, the D 120 instance); launches: h2o generate, "
            f"{GEN_STEPS} steps"),
        kernel_entry(
            "flash_attention_bwd",
            "src/repro_torch/csrc/flash_attention_bwd.cu",
            FLASH_BWD_REPLACES,
            train_qwen["launches"]["flash_attention_bwd"],
            bwd[(QWEN_TRAIN[:6], bf16)],
            f"B2 H32 Kh8 S2048 D128 causal bf16 (qwen3-4b's train shape); "
            f"launches: {TRAIN_STEPS} full-depth qwen3-4b train steps, "
            f"{bwd_bf16} kernels a call"),
        kernel_entry(
            "rglru_scan_bwd", "src/repro_torch/csrc/rglru_scan_bwd.cu",
            RGLRU_BWD_REPLACES,
            train_hyb["launches"]["rglru_scan_bwd"],
            bwd[(RG_TRAIN, False)],
            "[2, 2100, 4096] fp32, no h0 (recurrentgemma-9b's train "
            "shape); launches: one train step of the (rec, rec, attn) "
            "pattern"),
        kernel_entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:79",
            flash_launches(MOE_PAIRS[0], L4_SERVE),
            fl[("path", L4_SERVE[:6], str(L4_SERVE[6]), bf16)],
            "B2 H40 Kh8 S48 D128 chunk 8192 bf16 (llama4-scout-17b-a16e "
            "serving, G 5); launches: at this shape (chunked and full "
            "layers), one FIKIT serve_pair run of pair H"),
        kernel_entry(
            "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:71",
            gen[LLAMA4_L4]["launches"]["decode_attention"],
            dec[(DEC_L4[:5], str(DEC_L4[5]), bf16)],
            "B1 H40 Kh8 C8192 D128 chunk 8192 bf16 wrapped ring "
            "(llama4-scout-17b-a16e generation, G 5); launches: llama4 "
            f"({LLAMA4_L4}) generate, {GEN_STEPS} steps"),
        kernel_entry(
            "flash_attention_bwd",
            "src/repro_torch/csrc/flash_attention_bwd.cu",
            FLASH_BWD_REPLACES,
            sum(r["launches"]["flash_attention_bwd"] for r in train_moe),
            bwd[(L4_TRAIN[:6], bf16)],
            f"B2 H40 Kh8 S2048 D128 bf16 (llama4-scout-17b-a16e's layer "
            f"at the train shape, G 5); launches: phase 4 (d), one "
            f"chunked and one full layer, {bwd_bf16} kernels a call"),
    ]
    gemm = moe_gemm["cases"][(4096, False, "bfloat16")]
    entries.append(dict(
        {"name": "moe_grouped_ffn", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_grouped_gemm.cu",
         "replaces": "none: the JAX package runs its experts as padded "
                     "batched products (src/repro/models/moe.py)",
         "launches": moe_gemm["service"]["launches"]},
        **{k: gemm[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        shape="T4096 k8 D2048 F768 E128 bf16, even routing (a Qwen3-30B-"
              "A3B layer at B2 S2048); launches: the 4-layer cut's eager "
              "run, capture and replay_check"))
    unused = [e["shape"] for e in entries if e["launches"] < 1]
    if unused:
        raise AssertionError(f"no launch on the path at {unused}")
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
