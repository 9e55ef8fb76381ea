#!/usr/bin/env python3
"""Split the flash attention backward's device time between its kernels.

    python3 scripts/torch_flash_bwd_profile.py

At ``chip_smoke.QWEN_TRAIN`` and ``chip_smoke.HYB_TRAIN`` in bf16, on
transposed [B, S, H, D] views as ``attend`` hands them over, it calls
``flash_attention_bwd_kernel`` 20 times under ``torch.profiler`` and
prints, per kernel of the library (``flash_bwd_*``), its launches and mean
device time, beside the call's median time from ``chip_smoke.device_ms``
and the launch plan. The first line is the card's ``nvidia-smi`` name and
power limit. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.kernel import (
        bwd_plan, flash_attention_bwd_kernel)
    if not torch.cuda.is_available():
        print("torch_flash_bwd_profile: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    calls = 20
    for label, (B, H, Kh, Sq, Sk, D, kw) in {
            "qwen3_train": cs.QWEN_TRAIN, "hybrid_train": cs.HYB_TRAIN}.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda")
                   .bfloat16().transpose(1, 2)
                   for S, n in ((Sq, H), (Sk, Kh), (Sk, Kh)))
        dout = torch.randn(B, H, Sq, D, generator=g, device="cuda").bfloat16()

        def call():
            return flash_attention_bwd_kernel(q, k, v, dout, **kw)
        call_ms = cs.device_ms(torch, call, 10)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            if "flash_bwd" not in ev.key:
                continue
            total = getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0.0))
            m = re.search(r"flash_bwd_\w+(<[^>]*>)?", ev.key)
            name = m.group(0) if m else ev.key
            kernels[name] = {"launches": ev.count,
                             "mean_ms": total / max(ev.count, 1) / 1e3}
        print(json.dumps({
            "shape": label, "case": [B, H, Kh, Sq, Sk, D, kw],
            "call_ms_median": call_ms,
            "kernels": kernels or "not measured (no device time traced)",
            "plan": bwd_plan(B, H, Kh, Sq, Sk, D, torch.bfloat16)._asdict(),
        }), flush=True)
        del q, k, v, dout
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
