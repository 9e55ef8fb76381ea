#!/usr/bin/env python3
"""Compare checkouts of the PyTorch/CUDA port on one card: the time of
``api.prefill``, of a decode step, and of the flash and decode attention
and RG-LRU scan kernels at the paths' shapes.

    python3 scripts/torch_compare_trees.py PARENT . . PARENT

Each argument is the root of a checkout (``PARENT`` e.g. unpacked with
``git archive <commit> | tar -x -C PARENT`` into a git-ignored directory).
Each is measured in its own process, in the order given, so that two
versions are compared on one card in turns (parent, change, change,
parent). Per tree it prints one JSON line: the median of 3 prefills
(after a warm-up; host clock around a synchronised call) of full-width
qwen3-4b (B2, prompt 1024), recurrentgemma-9b (B2, prompt 2100) and
mamba2-2.7b (B2, prompt 2048), random bf16 weights from seed 0, and the
median of the 16 decode steps after a prefill (``chip_smoke.GENERATE``
of this checkout); the flash kernel's median device time (ms) on bf16 transposed
[B, S, H, D] views, as ``attend`` hands them over; and the decode
kernel's at ``DEC_HI``, ``DEC_HYB`` and ``DEC_LONG`` on bf16 transposed
views of the model's [B, C, Kh, D] cache, as ``decode_attend`` hands
them over (no copies); and the scan kernel's at ``RG_SERVE`` and
``RG_PREFILL`` on fp32 a, b and h0, as the rec blocks hand them over.
Shapes, the timings and the device timer are
``chip_smoke.py``'s (this checkout's, for every tree measured).
The first line is the card's ``nvidia-smi`` name and power limit. Needs a
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))




def measure(root: str) -> dict:
    """The numbers of the checkout at ``root``, in this process."""
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.models import api
    if not torch.cuda.is_available():
        raise SystemExit("torch_compare_trees: no CUDA device")
    out = {"tree": root}
    for name, batch, prompt in cs.GENERATE:
        cfg = get_config(name)
        model = api.build_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        inputs, start = cs.prompt_inputs(torch, cfg, batch, prompt, g)
        out[f"{name}_prefill_ms"] = statistics.median(
            cs.prefill_times(torch, model, inputs, cfg))
        steps = torch.randint(0, cfg.vocab_size, (cs.GEN_STEPS, batch, 1),
                              dtype=torch.int32, device="cuda", generator=g)
        _, times, _ = cs.generate(torch, model, inputs, start, steps, cfg)
        out[f"{name}_decode_step_ms"] = statistics.median(times)
        del model
        torch.cuda.empty_cache()
    shapes = {"qwen3_serving": cs.HI_SHAPE, "stablelm_serving": cs.LO_SHAPE,
              "hybrid_serving": cs.HYB_SHAPE,
              "granite_serving": cs.GRANITE_SHAPE,
              "qwen3_prompt": cs.HI_PROMPT,
              "hybrid_prompt": cs.HYB_PROMPT, "long": cs.LONG}
    for label, (B, H, Kh, Sq, Sk, D, kw) in shapes.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda")
                   .bfloat16().transpose(1, 2)
                   for S, n in ((Sq, H), (Sk, Kh), (Sk, Kh)))
        out[f"flash_{label}_ms"] = cs.device_ms(
            torch, lambda: ops.flash_attention(q, k, v, **kw),
            5 if Sq >= 2048 else 20)
    shapes = {"qwen3": cs.DEC_HI, "hybrid": cs.DEC_HYB, "long": cs.DEC_LONG}
    for label, (B, H, Kh, C, D, kw, pos) in shapes.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(B, H, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, C, Kh, D, generator=g, device="cuda")
                .bfloat16().transpose(1, 2) for _ in range(2))
        kpos = cs.ring_kpos(torch, C, pos)
        out[f"decode_{label}_ms"] = cs.device_ms(
            torch, lambda: dec_ops.decode_attention(q, k, v, kpos, pos, **kw),
            5 if C >= 8192 else 20)
    for label, case in {"serving": cs.RG_SERVE,
                        "prompt": cs.RG_PREFILL}.items():
        a, b, h0 = cs.rglru_inputs(torch, case, torch.float32, 0)
        out[f"rglru_{label}_ms"] = cs.device_ms(
            torch, lambda: rg_ops.rglru_scan(a, b, h0),
            20 if case[1] <= 512 else 4)
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(os.path.abspath(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for root in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], timeout=1800)
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
