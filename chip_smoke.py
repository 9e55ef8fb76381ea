#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: nvcc builds every kernel of the serving path from the sources
   in this checkout (``src/repro_torch/csrc``) for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the test shapes, the serving shapes, a ragged, an all-masked and a
   long case, in fp32 (tolerance 2e-5) and bf16 (2e-2); prints the error
   and the median times of the kernel, the plain version and one PyTorch
   library call of the same function (a yardstick only), beside the
   least time the card could take (bytes over 3.35 TB/s or operations
   over the peak rate of the input type, whichever is larger);
4. model: full-width, full-depth qwen3-4b and stablelm-1.6b (random bf16
   weights from a seed) give finite logits of the right shape, and one
   layer of each agrees with the same layer run on the plain attention;
5. serving: ``serve_pair`` hosts both models at full size under FIKIT
   and under SHARING (measurement phase, then the sharing phase); the
   kernel's launch counter is read around each run and must show every
   attention call of the run;
6. profile: the measurement phase's SK/SG per segment of each service at
   full size, beside one layer's device time.

The second-to-last lines are a JSON object of the kernels and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
HI, LO = "qwen3-4b", "stablelm-1.6b"
REQUESTS, MEASURE_RUNS = 4, 3

# B, H, Kh, Sq, Sk, D, kwargs
TEST_CASES = [                        # tests/test_kernels.py's shapes
    (2, 4, 4, 256, 256, 64, {}),
    (1, 8, 2, 256, 256, 128, dict(window=96)),
    (2, 4, 1, 384, 384, 64, dict(chunk=128)),
    (1, 2, 2, 128, 512, 64, dict(causal=False)),
    (1, 4, 4, 512, 512, 96, dict(window=128)),
]
HI_SHAPE = (2, 32, 8, 48, 48, 128, {})      # qwen3-4b at batch 2, seq 48
LO_SHAPE = (4, 32, 32, 48, 48, 64, {})      # stablelm-1.6b at batch 4
RAGGED = (2, 4, 2, 48, 48, 64, dict(window=16))
ALL_MASKED = (1, 4, 2, 40, 72, 64, dict(window=0))
LONG = (1, 32, 8, 4096, 4096, 128, {})


def log(msg: str) -> None:
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
    half the sleep, the window is taken again with a longer sleep, up to
    three times (a ``fn`` that waits on the card itself never gets
    ahead of it, and its last window is kept)."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 20_000_000, []
    for _ in range(reps):
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


def bound(torch, case, dtype):
    """Least time (ms) the card could take for the kernel's work, and what
    bounds it: each input read once and the output written once over
    HBM bandwidth, against QK^T and PV on the kept pairs over the peak
    rate of the input type (bf16 tensor cores, or fp32 outside them)."""
    B, H, Kh, Sq, Sk, D, kw = case
    esz = 2 if dtype == torch.bfloat16 else 4
    nbytes = esz * D * (2 * B * H * Sq + 2 * B * Kh * Sk)
    flops = 4 * D * B * H * allowed_pairs(torch, Sq, Sk, **kw)[1]
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernel_case(torch, ops, ref, case, dtype, seed):
    """Kernel vs plain version on the card; returns the case's record."""
    import torch.nn.functional as F
    B, H, Kh, Sq, Sk, D, kw = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Kh, Sk, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Kh, Sk, D, generator=g, device="cuda").to(dtype)
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    name = str(dtype).split(".")[1]
    if not (err < TOL[name]) or out.dtype != dtype or out.shape != want.shape:
        raise AssertionError(f"flash_attention {case[:6]} {kw} {name}: "
                             f"max|kernel - plain| = {err} (tol {TOL[name]})")
    n = 5 if Sq >= 4096 else 20
    ms = device_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), n)
    plain_ms = device_ms(torch,
                         lambda: ref.flash_attention_ref(q, k, v, **kw), n)
    # yardstick only: PyTorch's fused attention on the same inputs (kv
    # heads expanded and the mask built outside the timed call)
    G = H // Kh
    ke, ve = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    mask, _ = allowed_pairs(torch, Sq, Sk, **kw)
    if kw or Sq != Sk:
        mask = mask.cuda()
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, ke, ve, attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, ke, ve, is_causal=True)
    library_ms = device_ms(torch, lib, n)
    bound_ms, bound_by = bound(torch, case, dtype)
    rec = {"shape": list(case[:6]), "kw": kw, "dtype": name,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    log(f"  flash_attention {case[:6]} {kw} {name}: err {err:.3g} | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return rec


def model_check(torch, ops, ref, name, batch, seq):
    """Full-size model: finite logits of the right shape, and layer 0 with
    the kernel against layer 0 on the plain attention."""
    from repro_torch.config import get_config
    from repro_torch.models import api, transformer as tfm
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = api.build_params(cfg, seed=0, device="cuda")
    tokens = api.make_batch(cfg, batch, seq, device="cuda")
    with torch.inference_mode():
        logits, _ = api.forward(model, tokens, cfg)
        if tuple(logits.shape) != (batch, seq, cfg.vocab_size):
            raise AssertionError(f"{name} logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name} logits are not finite")
        x = tfm.embed_tokens(model, tokens, cfg)
        pos = tfm.positions_for(x)
        layer = model.layers[0]
        y = tfm.layer_apply(layer, x, pos, cfg)
        with mock.patch.object(ops, "flash_attention",
                               ref.flash_attention_ref):
            y_ref = tfm.layer_apply(layer, x, pos, cfg)
    torch.cuda.synchronize()
    diff = float((y.float() - y_ref.float()).abs().max())
    scale = float(y_ref.float().abs().max())
    log(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"logits {tuple(logits.shape)} finite; layer 0 max|kernel - plain| "
        f"{diff:.4g} of max|out| {scale:.4g} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not diff <= 2e-2 * scale:
        raise AssertionError(f"{name} layer 0: {diff} > 2e-2 * {scale}")
    del model, logits


def serve_run(torch, ops, mode):
    """The port's main path: serve_pair at full size under ``mode``."""
    from repro_torch.config import get_config
    from repro_torch.launch.serve import serve_pair
    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = serve_pair(HI, LO, mode=mode, reduced=False, device="cuda",
                     requests=REQUESTS, measure_runs=MEASURE_RUNS,
                     verbose=False)
    launches = ops.flash_attention.launches
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    per_run = get_config(HI).num_layers + get_config(LO).num_layers
    need = per_run * (1 + MEASURE_RUNS + REQUESTS)
    rec = dict(out, launches=launches, peak_mem_bytes=peak, wall_s=wall)
    log(f"  {mode}: " + json.dumps(rec))
    if launches < need:
        raise AssertionError(f"{mode}: flash_attention launched {launches} "
                             f"times, the run needs at least {need}")
    if not (out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0):
        raise AssertionError(f"{mode}: JCTs {out}")
    return rec


def segment_profile(torch):
    """Where a request's time goes: the measurement phase's per-run JCTs,
    SK (mean segment time incl. its device sync) and SG (host gap after
    it) per KernelID, beside the device time of one layer alone."""
    from repro_torch.config import get_config
    from repro_torch.core.policy import Mode
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import InferenceService, ServingSystem
    hi = InferenceService(get_config(HI), priority=0, batch=2, seq=48,
                          host_gap=0.002)
    lo = InferenceService(get_config(LO), priority=5, batch=4, seq=48)
    with ServingSystem(Mode.FIKIT, measure_runs=MEASURE_RUNS) as sys_:
        for svc in (hi, lo):
            jcts = sys_.onboard(svc)
            prof = sys_.profiles.get(svc.key)
            model, cfg = svc.svc.model, svc.cfg
            x = tfm.embed_tokens(model, svc.svc.make_input(), cfg)
            pos = tfm.positions_for(x)
            # a layer is ~100 launches: 4 of them stay inside the card's
            # launch queue, so the host never blocks behind the sleep
            with torch.inference_mode():
                layer_ms = device_ms(torch, lambda: tfm.layer_apply(
                    model.layers[0], x, pos, cfg), n=4)
            rec = {"measure_jct_ms": [1e3 * j for j in jcts],
                   "SK_ms": {k.name: 1e3 * v for k, v in prof.SK.items()},
                   "SG_ms": {k.name: 1e3 * v for k, v in prof.SG.items()},
                   "layer_device_ms": layer_ms}
            log(f"  {cfg.name}: " + json.dumps(rec))
    del hi, lo
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernel.library()
    log(f"[build] flash_attention.cu built with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[kernels] flash_attention vs its plain version")
    records = {}
    seed = 0
    for case in TEST_CASES + [HI_SHAPE, LO_SHAPE, RAGGED, ALL_MASKED]:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            records[(case[:6], str(dtype))] = check_kernel_case(
                torch, ops, ref, case, dtype, seed)
    records["long"] = check_kernel_case(torch, ops, ref, LONG,
                                        torch.bfloat16, seed + 1)

    log("[model] full-size models, kernel vs plain attention in layer 0")
    model_check(torch, ops, ref, HI, 2, 48)
    gc.collect()
    torch.cuda.empty_cache()
    model_check(torch, ops, ref, LO, 4, 48)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[serve] serve_pair({HI!r}, {LO!r}, reduced=False, "
        f"requests={REQUESTS}, measure_runs={MEASURE_RUNS})")
    fikit = serve_run(torch, ops, "fikit")
    sharing = serve_run(torch, ops, "sharing")
    log(f"  high-priority JCT: FIKIT {fikit['high_jct_ms']:.3f} ms vs "
        f"SHARING {sharing['high_jct_ms']:.3f} ms (ratio "
        f"{fikit['high_jct_ms'] / sharing['high_jct_ms']:.3f}); low: FIKIT "
        f"{fikit['low_jct_ms']:.3f} ms vs SHARING "
        f"{sharing['low_jct_ms']:.3f} ms; fills {fikit['fills']}")

    log("[profile] measurement phase: SK/SG per segment, one layer's "
        "device time")
    segment_profile(torch)

    hi = records[(HI_SHAPE[:6], str(torch.bfloat16))]
    lo = records[(LO_SHAPE[:6], str(torch.bfloat16))]
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
        "launches": fikit["launches"],
        "max_abs_err": max(hi["max_abs_err"], lo["max_abs_err"]),
        "ms": hi["ms"],
        "plain_ms": hi["plain_ms"],
        "bound_ms": hi["bound_ms"],
        "bound_by": hi["bound_by"],
        "library_ms": hi["library_ms"],
        "shape": "B2 H32 Kh8 S48 D128 bf16 (qwen3-4b serving)",
    }
    log(json.dumps({"kernels": [entry]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
