#!/usr/bin/env python3
"""Where the time of one full-width mamba2-2.7b layer and one granite-20b
layer goes, on one card: host time against device time, and the device
kernels by kind.

    python3 scripts/torch_layer_profile.py

Cases (random bf16 weights from seed 0, a random bf16 input):
- mamba2-2.7b at the generate phase's prompt (B 2, S 2048: 8 SSD chunks
  of 256) and at serving (B 4, S 48: one chunk of 48);
- granite-20b at serving (B 4, S 48).

Per case, one JSON line:
- ``host_ms``: median host clock of 5 synchronised calls of the layer;
- ``device_ms``: the layer's device time (``chip_smoke.device_ms``, 3
  calls queued behind a sleep kernel, so the card never waits for the
  host);
- ``parts_device_ms`` (mamba2): the mixer's steps alone, on the inputs
  the layer gives them: the norm, projections, convs and gates
  (``_mixer_inputs``), the chunked SSD scan (``_ssd_chunked``) and the
  gated output projection (``_gated_out``);
- ``kernels``: a ``torch.profiler`` trace of 3 calls: device kernels per
  call, their device time per call split into matmuls (GEMM kernels by
  name) and everything else, the device's busy share of the traced
  window (kernel time over host time), and the 8 longest kernels.

The first line is the card's ``nvidia-smi`` name and power limit. Needs
a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 3
GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)
CASES = (("mamba2-2.7b", 2, 2048), ("mamba2-2.7b", 4, 48),
         ("granite-20b", 4, 48))


def host_ms(torch, fn, runs: int = 5) -> float:
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def kernel_view(torch, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    classes = {"matmul": 0.0, "other": 0.0}
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us() / CALLS
        count += 1
        classes["matmul" if GEMM.search(e.name) else "other"] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not by_name:
        raise SystemExit("torch_layer_profile: the trace holds no device "
                         "kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    total = sum(classes.values())
    return {"kernels_per_call": count / CALLS, "per_call_us": classes,
            "total_us": total,
            "busy_share": CALLS * total / window_us,
            "top_us": [[n[:90], us] for n, us in top]}


def profile_case(torch, cs, name: str, batch: int, seq: int) -> dict:
    from repro_torch.config import get_config
    from repro_torch.models import mamba2, segmentation
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import Maker, torch_dtype
    cfg = get_config(name)
    dtype = torch_dtype(cfg.dtype)
    make = Maker(0, dtype, "cuda")
    lp = (mamba2.layer_build(make, cfg, 0) if cfg.family == "ssm"
          else tfm.layer_build(make, cfg, 0))
    fn = segmentation.layer_fn(cfg, 0)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, seq, cfg.d_model, generator=g,
                    device="cuda").to(dtype)
    rec = {"model": name, "batch": batch, "seq": seq}
    with torch.inference_mode():
        def layer():
            return fn(lp, x, cfg)
        rec["host_ms"] = host_ms(torch, layer)
        rec["device_ms"] = cs.device_ms(torch, layer, n=CALLS)
        if cfg.family == "ssm":
            z, xi, Bi, Ci, dt, A, _ = mamba2._mixer_inputs(lp, x, cfg, None)
            xh = xi.reshape(batch, seq, cfg.ssm_nheads, cfg.ssm_headdim)
            y, _ = mamba2._ssd_chunked(xh, dt, A, Bi, Ci, cfg.ssm_chunk)
            parts = {
                "mixer_inputs": lambda: mamba2._mixer_inputs(lp, x, cfg,
                                                             None),
                "ssd_chunked": lambda: mamba2._ssd_chunked(
                    xh, dt, A, Bi, Ci, cfg.ssm_chunk),
                "gated_out": lambda: mamba2._gated_out(lp, y, z, xh, cfg),
            }
            rec["parts_device_ms"] = {k: cs.device_ms(torch, p, n=CALLS)
                                      for k, p in parts.items()}
        rec["kernels"] = kernel_view(torch, layer)
    return rec


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_layer_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, batch, seq in CASES:
        print(json.dumps(profile_case(torch, cs, name, batch, seq)),
              flush=True)
        cs.free(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
