#!/usr/bin/env python3
"""Time the bf16 decode attention kernel under several split counts at
``chip_smoke.py``'s three decode shapes, beside the plan that
``split_plan`` chooses, on one card.

    python3 scripts/torch_decode_plan_sweep.py

Shapes are ``DEC_HI`` (qwen3-4b), ``DEC_HYB`` (recurrentgemma-9b, a
wrapped ring) and ``DEC_LONG``, on bf16 transposed views of the model's
[B, C, Kh, D] cache. A forced count s cuts the cache into splits of
16 * ceil(tiles / s) slots; everything else is the chosen plan's. Each
result is held to the plain version (2e-2) before it is timed with
``chip_smoke.device_ms``. The first line is the card's ``nvidia-smi`` name
and power limit, then one JSON line per shape: the chosen plan and the
median device time (µs) per forced count. Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = {"qwen3": (5, 7, 9, 13, 17, 22, 33),
          "hybrid": (8, 12, 16, 24, 32, 48, 64),
          "long": (17, 33, 50, 66, 132)}


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    if not torch.cuda.is_available():
        print("torch_decode_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = kernel.split_plan
    shapes = {"qwen3": cs.DEC_HI, "hybrid": cs.DEC_HYB, "long": cs.DEC_LONG}
    for label, (B, H, Kh, C, D, kw, pos) in shapes.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(B, H, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, C, Kh, D, generator=g, device="cuda")
                .bfloat16().transpose(1, 2) for _ in range(2))
        kpos = cs.ring_kpos(torch, C, pos)
        want = ref.decode_attention_ref(q, k, v, kpos, pos, **kw)

        def timed():
            out = ops.decode_attention(q, k, v, kpos, pos, **kw)
            err = float((out.float() - want.float()).abs().max())
            if not err < cs.TOL["bfloat16"]:
                raise AssertionError(f"{label}: max|kernel - plain| {err}")
            return 1e3 * cs.device_ms(
                torch, lambda: ops.decode_attention(q, k, v, kpos, pos, **kw),
                5 if C >= 8192 else 20)
        plan = chosen(B * Kh, H // Kh, C, D, sms)
        row = {"shape": label, "plan": plan._asdict(), "chosen_us": timed()}
        tiles = -(-C // kernel.TILE)
        for count in COUNTS[label]:
            split_len = kernel.TILE * -(-tiles // count)

            def forced(*args, split_len=split_len):
                return chosen(*args)._replace(splits=-(-C // split_len),
                                              split_len=split_len)
            kernel.split_plan = forced
            try:
                row[f"splits_{-(-C // split_len)}_us"] = timed()
            finally:
                kernel.split_plan = chosen
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
