"""The control of a cell's outputs check: the plain reference put in the
program's place, computed in float8 (``Arith(fp8=True)``), on the high
prompts a run of the same seed checks and on low prompts drawn from the
seed among those its backlog sends. It must read as not correct: its
widest logit gap against the float32 reference, beside the cell's
limits.

    python3 servebench/control.py --workload F.fill --seeds 1,2,3 \\
        --seconds 50

Prints a JSON line per seed. The benchmark's own runs never run it; it
needs no window, since a control only has to be read at each position of
the same prompts. It imports nothing of the program.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]


def control_gaps(cell, seed: int, seconds: float, device,
                 cfgs=None) -> dict:
    """{role: (control gap, requests)} for the requests a run of ``seed``
    over ``seconds`` samples; ``cfgs`` overrides the configurations'
    ``port`` fields (smaller sizes in tests)."""
    import torch
    from servebench import traffic, weights as wt
    from servebench.catalog import load_reference
    from servebench.compare import logit_gap
    from servebench.reference.arith import Arith

    mix = cell.mix
    n_high = len(traffic.open_loop(mix["high"]["arrivals"], seconds, seed))
    sample = traffic.sampled(mix, seed, n_high)
    # the high requests a run checks; of the low backlog, prompts drawn
    # from the seed (a run checks those that the requests it keeps sent)
    rids = {"high": sample["high"], "low": sample["low_prompts"]}
    out = {}
    for role in ("high", "low"):
        model = cell.config[role]
        cfg = (cfgs or {}).get(role, model["port"])
        ref = load_reference(model["reference"])
        params = wt.make(ref.param_specs(cfg), wt.generator(seed, role,
                                                            device),
                         getattr(torch, cfg["dtype"]), device)
        m = mix[role]
        count = n_high if role == "high" else traffic.LOW_PROMPTS
        prompts = traffic.prompts(seed, role, count, m["batch"], m["seq"],
                                  cfg["vocab_size"], device)

        def w(name):
            return params[name].float()
        gap = 0.0
        for rid in rids[role]:
            tokens = prompts[rid]
            with torch.no_grad():
                exact = ref.logits(w, tokens, cfg, Arith())
                low = ref.logits(w, tokens, cfg, Arith(fp8=True))
            gap = max(gap, logit_gap(low, exact))
        out[role] = (gap, len(rids[role]))
        del params, prompts
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    from servebench.catalog import load_cell
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        gaps = control_gaps(cell, seed, args.seconds, args.device)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            **{f"{r}_logit_gap": {"control": g, "limit":
                                  cell.spec["limits"][f"{r}_logit_gap"],
                                  "requests": n}
               for r, (g, n) in gaps.items()},
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
