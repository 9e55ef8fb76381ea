#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: nvcc builds every kernel of the port's paths from the sources
   in this checkout (``src/repro_torch/csrc``) for sm_90a, one nvcc per
   source, all started together; every bf16 instance of the flash kernel
   must show HGMMA (wgmma) and every bf16 instance of the decode kernel
   HMMA (mma.sync) in ``cuobjdump -sass``, and none of them, nor either
   instance of the rglru_scan kernel (fp32, bf16; no tensor cores), may
   spill in ptxas's report;
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
   prompt; prints the error and the median times of the kernel, the
   plain version and one PyTorch library call of the same function where
   there is one (a yardstick only), beside the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   the input type, whichever is larger);
4. model: full-width, full-depth qwen3-4b, stablelm-1.6b,
   recurrentgemma-9b, granite-20b and mamba2-2.7b (random bf16 weights
   from a seed) give finite logits of the right shape; one layer of each
   dense model and one rec and one attn block of the hybrid agree with
   the same block run on the plain versions; mamba2, which runs no
   kernel, is held to itself in its two forms: each layer's chunked scan
   over S tokens against the recurrent decode of the last token from the
   cache of the first S - 1 (the whole model's last-position logits from
   prefill + ``decode_step`` are reported beside ``forward``'s);
5. generate: prefill then 16 ``decode_step``s of full-width qwen3-4b
   (B2, prompt 1024), recurrentgemma-9b (B2, prompt 2100, past its 2048
   window, so the cache is a wrapped ring) and mamba2-2.7b (B2, prompt
   2048, a multiple of its 256-token SSD chunk); logits at every step
   against the same run on the plain versions, the decode kernel's
   launches = steps x attention layers, flash's = attention layers (0
   for mamba2), the time of ``api.prefill`` (host clock around a
   synchronised call, median of 3) and the time per decode step;
6. serving: ``serve_pair`` hosts qwen3-4b (Q0) with stablelm-1.6b, with
   recurrentgemma-9b (pair E of the paper's Fig 16), with mamba2-2.7b
   (pair A) and with granite-20b (pair B), at full size under FIKIT and
   under SHARING; every kernel's launch counter is set to 0 before each
   run and read after it, and must show every call of the run;
7. profile: the measurement phase's SK/SG per segment of each service at
   full size, beside one layer's (or block's) device time.

Every path (generate, each serving run) is driven with all launch
counters set to 0 just before it and read just after; launches made to
compare a kernel with its plain version are not counted. The
second-to-last lines are a JSON object of the kernels and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
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
# plan, rglru_scan's scan plan)
PLAN_SHOWN = ("splits", "split_len", "tw", "nseg", "threads", "blocks",
              "ctas", "stages", "smem_bytes", "partial_bytes")
RGLRU_TOL = 1e-4
HI, LO, HYB = "qwen3-4b", "stablelm-1.6b", "recurrentgemma-9b"
SSM_LO, GRANITE = "mamba2-2.7b", "granite-20b"    # pairs A and B
LOW_SERVICES = (LO, HYB, SSM_LO, GRANITE)
REQUESTS, MEASURE_RUNS = 4, 3
GEN_STEPS = 16
# the generate phase's (model, batch, prompt): past the hybrid's 2048
# window; mamba2's prompt a multiple of its 256-token SSD chunk
GENERATE = ((HYB, 2, 2100), (HI, 2, 1024), (SSM_LO, 2, 2048))
KERNELS = ("flash_attention", "decode_attention", "rglru_scan")

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
    ms = device_ms(torch, kernel_fn, n)
    plain_ms = device_ms(torch, plain_fn, plain_n or max(1, n // 4))
    library_ms = None if lib_fn is None else device_ms(torch, lib_fn, n)
    bound_ms, bound_by = bound
    rec = dict(extra, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    if "scaled_err" in extra:
        err = f"{err:.3g} (scaled {extra['scaled_err']:.3g})"
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
    esz = 2 if dtype == torch.bfloat16 else 4
    bound = least_ms(esz * (2 * B * H * D + 2 * B * Kh * C * D) + 4 * C,
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


# ----------------------------------------------------------- model phases
def launchers(K) -> dict:
    """The kernels' wrappers as imported, whose ``launches`` count kernel
    launches (a patched module attribute does not hide them)."""
    return {name: getattr(K[name][0], name) for name in KERNELS}


def reset_launches(K) -> None:
    for fn in K["launchers"].values():
        fn.launches = 0


def read_launches(K) -> dict:
    return {name: fn.launches for name, fn in K["launchers"].items()}


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
            checked.launches = 0
            stack.enter_context(mock.patch.object(ops, name, checked))
        yield {"worst_err_to_limit": worst, "calls": calls}


def close_enough(label, y, y_ref, rel=2e-2):
    """bf16 agreement: max|kernel - plain| within ``rel`` of max|plain|."""
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
    mamba2, its chunked form against its recurrent one)."""
    from repro_torch.config import get_config
    from repro_torch.models import api, rglru, segmentation
    from repro_torch.models import transformer as tfm
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = api.build_params(cfg, seed=0, device="cuda")
    tokens = api.make_batch(cfg, batch, seq, device="cuda")
    notes = []
    with torch.inference_mode():
        logits, _ = api.forward(model, tokens, cfg)
        if tuple(logits.shape) != (batch, seq, cfg.vocab_size):
            raise AssertionError(f"{name} logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name} logits are not finite")
        x = tfm.embed_tokens(model, tokens, cfg)
        if cfg.family == "hybrid":
            kinds = rglru.block_kinds(cfg)
            blocks = [(kind, model.blocks[kinds.index(kind)],
                       rglru.rec_block_apply if kind == "rec"
                       else rglru.attn_block_apply)
                      for kind in ("rec", "attn")]
        elif cfg.family == "ssm":
            blocks = []
            notes.append(ssm_forms_check(torch, model, tokens, logits, cfg))
        else:
            blocks = [("layer 0", model.layers[0],
                       segmentation.layer_fn(cfg))]
        for label, block, fn in blocks:
            y = fn(block, x, cfg)
            with plain_versions(K):
                y_ref = fn(block, x, cfg)
            diff, scale = close_enough(f"{name} {label}", y, y_ref)
            notes.append(f"{label} max|kernel - plain| {diff:.4g} of "
                         f"max|out| {scale:.4g}")
    torch.cuda.synchronize()
    log(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"logits {tuple(logits.shape)} finite; " + "; ".join(notes)
        + f" ({time.perf_counter() - t0:.1f} s)")
    del logits
    return model if keep else None


def prefill_times(torch, model, tokens, cfg, runs: int = 3) -> list:
    """Host-clock ms of ``runs`` synchronised ``api.prefill`` calls (a
    cache GEN_STEPS beyond the prompt), after one warm-up call."""
    from repro_torch.models import api
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            api.prefill(model, tokens, cfg, extra_capacity=GEN_STEPS)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times[1:]


def generate(torch, model, tokens, steps, cfg):
    """Prefill ``tokens`` (a cache GEN_STEPS beyond the prompt), then one
    ``decode_step`` per row of ``steps``; returns the logits of every
    step, each step's host-clock ms (around a synchronised call) and the
    caches."""
    from repro_torch.models import api
    prompt = tokens.shape[1]
    times = []
    with torch.inference_mode():
        logits, caches = api.prefill(model, tokens, cfg,
                                     extra_capacity=GEN_STEPS)
        outs = [logits]
        for i in range(len(steps)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = api.decode_step(model, steps[i], prompt + i,
                                             caches, cfg)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            outs.append(logits)
    return outs, times, caches


def generate_check(torch, K, name, model, batch, prompt, hold_logits):
    """Prefill ``prompt`` tokens, then GEN_STEPS decode steps (tokens
    drawn up front, so every run sees the same ones). Three runs: the
    kernels' (timed, launches counted); the plain versions' (end-to-end
    logits compared with the kernels' at every step, and held to them
    when ``hold_logits``); and one where every kernel call is held to
    its plain version on the same inputs."""
    from repro_torch.config import get_config
    from repro_torch.models import api, rglru
    cfg = get_config(name)
    if model is None:
        model = api.build_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           dtype=torch.int32, device="cuda", generator=g)
    steps = torch.randint(0, cfg.vocab_size, (GEN_STEPS, batch, 1),
                          dtype=torch.int32, device="cuda", generator=g)

    def run():
        return generate(torch, model, tokens, steps, cfg)

    prefill = prefill_times(torch, model, tokens, cfg)
    free(torch)
    reset_launches(K)
    outs, times, caches = run()
    launches = read_launches(K)
    with plain_versions(K):
        ref_outs, _, _ = run()
    with checked_calls(K) as checked:
        run()
    if cfg.family == "hybrid":
        attn_layers = rglru.block_kinds(cfg).count("attn")
    else:                                # dense: every layer; SSM: none
        attn_layers = cfg.num_layers if cfg.family == "dense" else 0
    need = {"decode_attention": GEN_STEPS * attn_layers,
            "flash_attention": attn_layers}
    if cfg.family == "hybrid":
        need["rglru_scan"] = cfg.num_layers - attn_layers
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
    kv = [c for c in caches if hasattr(c, "pos")]
    if kv:
        size = {"cache_slots": kv[0].capacity}
    else:                        # SSM: a fixed-size state and conv buffers
        size = {"state_bytes": sum(t.numel() * t.element_size()
                                   for c in caches for t in c)}
    rec = {"model": name, "batch": batch, "prompt": prompt,
           "steps": GEN_STEPS, **size, "launches": launches,
           "prefill_ms_median": statistics.median(prefill),
           "prefill_ms": prefill,
           "decode_step_ms_median": statistics.median(times),
           "decode_step_ms": times, "logits_held": hold_logits,
           "logits_rel_err_per_step": rel, "argmax_agree_steps": agree,
           "per_call_check": checked}
    log(f"  {name}: " + json.dumps(rec))
    del model, caches, outs, ref_outs
    return rec


def serve_run(torch, K, low, mode):
    """A serving path: serve_pair at full size under ``mode``, with every
    launch counter set to 0 before it and read after it."""
    from repro_torch.config import get_config
    from repro_torch.launch.serve import serve_pair
    from repro_torch.models import rglru
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K)
    t0 = time.perf_counter()
    out = serve_pair(HI, low, mode=mode, reduced=False, device="cuda",
                     requests=REQUESTS, measure_runs=MEASURE_RUNS,
                     verbose=False)
    launches = read_launches(K)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    runs = 1 + MEASURE_RUNS + REQUESTS        # warmup, measured, served
    lcfg = get_config(low)
    lo_attn = lcfg.num_layers
    need = {}
    if lcfg.family == "hybrid":
        lo_attn = rglru.block_kinds(lcfg).count("attn")
        need["rglru_scan"] = (lcfg.num_layers - lo_attn) * runs
    elif lcfg.family == "ssm":               # no attention, no kernel
        lo_attn = 0
    need["flash_attention"] = (get_config(HI).num_layers + lo_attn) * runs
    rec = dict(out, low=low, launches=launches, peak_mem_bytes=peak,
               wall_s=wall)
    log(f"  {low} {mode}: " + json.dumps(rec))
    short = {k: v for k, v in need.items() if launches[k] < v}
    if short or launches["flash_attention"] != need["flash_attention"]:
        raise AssertionError(f"{low} {mode}: launches {launches}, the run "
                             f"needs at least {need} (flash exactly)")
    if not (out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0):
        raise AssertionError(f"{mode}: JCTs {out}")
    return rec


def segment_profile(torch, low):
    """Where a request's time goes: the measurement phase's per-run JCTs,
    SK (mean segment time incl. its device sync) and SG (host gap after
    it) per KernelID, beside the device time of one layer (or one block
    of each kind) alone."""
    from repro_torch.config import get_config
    from repro_torch.core.policy import Mode
    from repro_torch.models import rglru, segmentation
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import InferenceService, ServingSystem
    hi = InferenceService(get_config(HI), priority=0, batch=2, seq=48,
                          host_gap=0.002)
    lo = InferenceService(get_config(low), priority=5, batch=4, seq=48)
    with ServingSystem(Mode.FIKIT, measure_runs=MEASURE_RUNS) as sys_:
        for svc in (hi, lo):
            jcts = sys_.onboard(svc)
            prof = sys_.profiles.get(svc.key)
            model, cfg = svc.svc.model, svc.cfg
            x = tfm.embed_tokens(model, svc.svc.make_input(), cfg)
            if cfg.family == "hybrid":
                kinds = rglru.block_kinds(cfg)
                blocks = {
                    "rec": lambda: rglru.rec_block_apply(
                        model.blocks[kinds.index("rec")], x, cfg),
                    "attn": lambda: rglru.attn_block_apply(
                        model.blocks[kinds.index("attn")], x, cfg)}
            else:
                fn = segmentation.layer_fn(cfg)
                blocks = {"layer": lambda: fn(model.layers[0], x, cfg)}
            # a block is ~100 launches: 4 of them stay inside the card's
            # launch queue, so the host never blocks behind the sleep
            with torch.inference_mode():
                dev = {k: device_ms(torch, fn, n=4)
                       for k, fn in blocks.items()}
            rec = {"measure_jct_ms": [1e3 * j for j in jcts],
                   "SK_ms": {k.name: 1e3 * v for k, v in prof.SK.items()},
                   "SG_ms": {k.name: 1e3 * v for k, v in prof.SG.items()},
                   "block_device_ms": dev}
            log(f"  {cfg.name}: " + json.dumps(rec))
    del hi, lo
    gc.collect()
    torch.cuda.empty_cache()


# the instances the build phase checks in each library: the kernel's
# mangled name, how to label an instance, the SASS opcode it must show
# (None: no tensor cores), and how many instances there are. flash and
# decode: their bf16 tensor-core instances; rglru_scan: both of its own.
INSTANCES = {
    "flash_attention": (r"flash_fwd_tcILi(\d+)ELi(\d+)E",
                        lambda t: f"D{t.group(1)} x{t.group(2)} warpgroups",
                        "HGMMA", 8),
    "decode_attention": (r"decode_split_tcILi(\d+)E",
                         lambda t: f"D{t.group(1)}", "HMMA", 3),
    "rglru_scan": (r"rglru_scan_splitI(f|13__nv_bfloat16)E",
                   lambda t: "fp32" if t.group(1) == "f" else "bf16",
                   None, 2),
}


def instance_check(lib, kernel: str) -> dict:
    """The checked instances of ``kernel`` in the built library:
    registers and spill bytes from ptxas's ``-v`` report beside it, and
    the count of its tensor-core instruction (flash: HGMMA, wgmma;
    decode: HMMA, mma.sync) in ``cuobjdump -sass``. Fails if an instance
    spills, or has no tensor-core instruction where one is expected."""
    pattern, label, opcode, expect = INSTANCES[kernel]

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
    bad = {k: v for k, v in inst.items() if v["spill_bytes"]}
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
        raise AssertionError(f"{kernel} bf16 instances {inst}: expected "
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
    libs = _build.build_all(KERNELS)
    log(f"[build] {', '.join(k + '.cu' for k in KERNELS)} built with nvcc "
        f"for sm_90a in {time.perf_counter() - t0:.1f} s (in parallel)")
    for name, (_, _, opcode, _) in INSTANCES.items():
        what = "bf16 instances (tensor cores)" if opcode else "instances"
        log(f"  {name} {what}: " + json.dumps(instance_check(libs[name],
                                                                name)))

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

    served = {}
    for low in LOW_SERVICES:
        log(f"[serve] serve_pair({HI!r}, {low!r}, reduced=False, "
            f"requests={REQUESTS}, measure_runs={MEASURE_RUNS})")
        fikit = serve_run(torch, K, low, "fikit")
        sharing = serve_run(torch, K, low, "sharing")
        served[low] = fikit
        log(f"  high-priority JCT: FIKIT {fikit['high_jct_ms']:.3f} ms vs "
            f"SHARING {sharing['high_jct_ms']:.3f} ms (ratio "
            f"{fikit['high_jct_ms'] / sharing['high_jct_ms']:.3f}); low: "
            f"FIKIT {fikit['low_jct_ms']:.3f} ms vs SHARING "
            f"{sharing['low_jct_ms']:.3f} ms; fills {fikit['fills']}")

    for low in LOW_SERVICES:
        log(f"[profile] {HI} + {low}, measurement phase: SK/SG per "
            f"segment, one block's device time")
        segment_profile(torch, low)

    pair_e = served[HYB]["launches"]
    entries = [
        kernel_entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:79",
            pair_e["flash_attention"], fl[("path", HI_SHAPE[:6], bf16)],
            "B2 H32 Kh8 S48 D128 bf16 (qwen3-4b serving, attend's "
            "transposed views); launches: one FIKIT serve_pair run of "
            "pair E"),
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
    ]
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
