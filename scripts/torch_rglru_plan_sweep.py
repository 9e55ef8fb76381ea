#!/usr/bin/env python3
"""Time the RG-LRU scan kernel under several forced plans at
``chip_smoke.py``'s three long scan shapes, beside the plan that
``scan_plan`` chooses, on one card; with ``--bwd``, its backward kernel
beside ``bwd_plan``'s choice.

    python3 scripts/torch_rglru_plan_sweep.py
    python3 scripts/torch_rglru_plan_sweep.py --bwd

Shapes are ``RG_SERVE`` (recurrentgemma-9b serving), ``RG_PREFILL`` (its
2100-token prompt at batch 2) and ``RG_LONG`` (batch 1, 8192 tokens), fp32
with an h0, and ``RG_PREFILL`` in bf16. A forced plan sets the column
tile and the segments a CTA (``kernel.plan_for``). Each result is held to
the plain version (1e-4 in fp32, 2e-2 in bf16) before it is timed with
``chip_smoke.device_ms``. The first line is the card's ``nvidia-smi`` name
and power limit, then one JSON line per shape: the chosen plan and the
median device time (µs) per plan. With ``--bwd`` the shapes are
``RG_TRAIN`` (the hybrid's train shape) in fp32 and bf16, without h0 as
the rec block trains, and ``RG_LONG``; each forced backward plan's
(da, db) is held to autograd of the plain version (``BWD_TOL`` of
max(1, max|plain|)) before ``rglru_scan_bwd_kernel`` is timed. Needs a
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (tw, nseg) forced per shape: narrower or wider tiles, fewer or more
# segments than the chosen plan's
FORCED = {"serving": ((32, 2), (16, 3), (16, 6)),
          "prompt": ((32, 4), (32, 5), (32, 7), (32, 8), (16, 12)),
          "long": ((16, 8), (16, 10), (16, 14), (16, 16), (32, 6)),
          "prompt_bf16": ((32, 8), (16, 8), (16, 12))}
# the backward's forced (tw, nseg), at most BWD_MAX_THREADS threads
FORCED_BWD = {"train": ((32, 2), (32, 3), (32, 5), (32, 6), (16, 8),
                        (16, 12), (8, 16)),
              "train_bf16": ((32, 3), (32, 4), (32, 5), (16, 8),
                             (16, 12)),
              "long": ((16, 4), (16, 6), (16, 10), (16, 12), (32, 4),
                       (32, 6))}


def sweep_bwd(torch, cs, kernel, ops, ref, sms) -> None:
    """One JSON line per backward shape: the chosen plan and the median
    device time (µs) of each plan, each held to the plain version."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {"train": (cs.RG_TRAIN, f32), "train_bf16": (cs.RG_TRAIN, bf16),
              "long": (cs.RG_LONG, f32)}
    chosen = kernel.bwd_plan
    for label, (case, dtype) in shapes.items():
        B, S, W = case
        a, b, _ = cs.rglru_inputs(torch, case, dtype, 0, with_h0=False)
        g = torch.Generator(device="cuda").manual_seed(1)
        dy = torch.randn(B, S, W, generator=g, device="cuda").to(dtype)
        h = ops.rglru_scan(a, b)
        plain_in = [t.detach().requires_grad_(True) for t in (a, b)]
        want = torch.autograd.grad(ref.rglru_scan_ref(*plain_in), plain_in,
                                   dy)
        del plain_in
        tol = cs.BWD_TOL[cs.dtype_name(dtype)]

        def timed():
            da, db, _ = kernel.rglru_scan_bwd_kernel(a, h, dy)
            for got, w in zip((da, db), want):
                err = float((got.float() - w.float()).abs().max()) / max(
                    1.0, float(w.float().abs().max()))
                if not err < tol:
                    raise AssertionError(f"{label}: backward error {err}")
            return 1e3 * cs.device_ms(
                torch, lambda: kernel.rglru_scan_bwd_kernel(a, h, dy), 10)
        plan = chosen(*case, dtype, sms)
        row = {"shape": label, "plan": plan._asdict(), "chosen_us": timed()}
        for tw, nseg in FORCED_BWD[label]:
            kernel.bwd_plan = (
                lambda B, S, W, *_, tw=tw, nseg=nseg:
                kernel.plan_for(B, S, W, tw, nseg, kernel.BWD_ROWS))
            try:
                row[f"tw{tw}_nseg{nseg}_us"] = timed()
            finally:
                kernel.bwd_plan = chosen
        print(json.dumps(row), flush=True)
        del a, b, h, dy, want


def main(argv) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.rglru_scan import kernel, ops, ref
    if not torch.cuda.is_available():
        print("torch_rglru_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if argv == ["--bwd"]:
        sweep_bwd(torch, cs, kernel, ops, ref, sms)
        return 0
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    chosen = kernel.scan_plan
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {"serving": (cs.RG_SERVE, f32), "prompt": (cs.RG_PREFILL, f32),
              "long": (cs.RG_LONG, f32), "prompt_bf16": (cs.RG_PREFILL, bf16)}
    for label, (case, dtype) in shapes.items():
        a, b, h0 = cs.rglru_inputs(torch, case, dtype, 0)
        want = ref.rglru_scan_ref(a, b, h0)
        tol = cs.RGLRU_TOL if dtype == f32 else cs.TOL["bfloat16"]

        def timed():
            out = ops.rglru_scan(a, b, h0)
            err = float((out.float() - want.float()).abs().max())
            if not err < tol:
                raise AssertionError(f"{label}: max|kernel - plain| {err}")
            return 1e3 * cs.device_ms(
                torch, lambda: ops.rglru_scan(a, b, h0),
                20 if case[1] <= 512 else 4)
        plan = chosen(*case, dtype, sms)
        row = {"shape": label, "plan": plan._asdict(), "chosen_us": timed()}
        for tw, nseg in FORCED[label]:
            kernel.scan_plan = (lambda B, S, W, *_, tw=tw, nseg=nseg:
                                kernel.plan_for(B, S, W, tw, nseg))
            try:
                row[f"tw{tw}_nseg{nseg}_us"] = timed()
            finally:
                kernel.scan_plan = chosen
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
