#!/usr/bin/env python3
"""Where the device time of one recurrentgemma-9b rec block goes at the
prompt shape (B 2, S 2100), on one card.

    python3 scripts/torch_rec_block_profile.py

One full-width rec block (random bf16 weights from seed 0) runs on a
random bf16 input. Two views, both device time:

- parts: each step of ``models/rglru.py``'s ``_rec_apply`` and
  ``_mlp_res`` run alone on the inputs the block gives it, timed with
  ``chip_smoke.device_ms``: the norm and the two input projections with
  the gelu (``_gate_and_y``), the causal conv, ``_rglru_gates`` whole and
  its two [W, W] matmuls alone (the rest are its fp32 elementwise ops),
  the scan kernel, the gated output projection, and the MLP half;
- kernels: a ``torch.profiler`` trace of 3 whole blocks, its device
  kernels summed per call into the scan kernel, matmuls (GEMM kernels by
  name) and everything else (elementwise and reductions), with the 12
  longest kernels by name.

The first line is the card's ``nvidia-smi`` name and power limit, then
one JSON line per view. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, PROMPT = 2, 2100
CALLS = 3
GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.models import rglru
    from repro_torch.models.layers import Maker, torch_dtype
    if not torch.cuda.is_available():
        print("torch_rec_block_profile: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(cs.HYB)
    dtype = torch_dtype(cfg.dtype)
    lp = rglru.RecBlock(Maker(0, dtype, "cuda"), cfg, 0)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, PROMPT, cfg.d_model, generator=g,
                    device="cuda").to(dtype)

    with torch.inference_mode():
        gate, y = rglru._gate_and_y(lp, x, cfg)
        yc, _ = rglru._causal_conv(y, lp.conv, None)
        a, b = rglru._rglru_gates(lp, yc, cfg)
        hs = ops.rglru_scan(a, b)
        x1 = x + (hs.to(dtype) * gate) @ lp.w_out
        parts = {
            "block": lambda: rglru.rec_block_apply(lp, x, cfg),
            "gate_and_y": lambda: rglru._gate_and_y(lp, x, cfg),
            "conv": lambda: rglru._causal_conv(y, lp.conv, None),
            "rglru_gates": lambda: rglru._rglru_gates(lp, yc, cfg),
            "rglru_gates_matmuls": lambda: (yc @ lp.w_r, yc @ lp.w_i),
            "scan": lambda: ops.rglru_scan(a, b),
            "out_proj": lambda: x + (hs.to(dtype) * gate) @ lp.w_out,
            "mlp": lambda: rglru._mlp_res(lp, x1, cfg),
        }
        part_ms = {k: cs.device_ms(torch, fn, n=CALLS)
                   for k, fn in parts.items()}
        part_ms["rglru_gates_elementwise"] = (
            part_ms["rglru_gates"] - part_ms["rglru_gates_matmuls"])
        print(json.dumps({"view": "parts", "shape": [BATCH, PROMPT],
                          "device_ms": part_ms}), flush=True)

        from torch.profiler import ProfilerActivity, profile
        parts["block"]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                parts["block"]()
            torch.cuda.synchronize()
    classes = {"scan": 0.0, "matmul": 0.0, "other": 0.0}
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us() / CALLS
        if "rglru_scan" in e.name:
            classes["scan"] += us
        elif GEMM.search(e.name):
            classes["matmul"] += us
        else:
            classes["other"] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not by_name:
        raise SystemExit("torch_rec_block_profile: the trace holds no "
                         "device kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"view": "kernels", "per_block_us": classes,
                      "total_us": sum(classes.values()),
                      "top_us": [[n[:90], us] for n, us in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
