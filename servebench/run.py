"""Run one cell of the port's serving benchmark on the card this process
sees, and print its result as the last line of standard output.

    python3 servebench/run.py --workload F.fill --seed 7 --seconds 50 \\
        --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones from a run with ``torch.profiler`` over a slice of the
window. Every run checks the served logits against the plain reference
and prints each number compared beside its limit, last on standard error
and under ``compared``, the last key of the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules(names) -> list:
    """The forbidden top-level names among module ``names``, each compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed place inside the checkout
    build = ROOT / "build" / "servebench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from servebench import harness

    cell = harness.load_cell(args.workload)
    chips = harness.benchmark_entries(cell)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this process "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda:0",
                           t_start=T_START,
                           log=lambda m: print(m, file=sys.stderr))
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 4
    run = out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["peak"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        t = run.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.device_ops(),
                               "idle_gaps": t.idle_gaps(run.spans)}
    result["compared"] = out["compared"]
    for name, c in out["compared"].items():
        fills = (f", {c['fill_layers']} of their layers in high gaps"
                 if "fill_layers" in c else "")
        print(f"compared {name} {c['value']!r} limit {c['limit']!r} "
              f"({c['requests']} requests{fills})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
