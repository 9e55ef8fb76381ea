"""Serving entry point: hosts a high/low priority service pair on the FIKIT
engine with batched requests — the end-to-end serving path of the port
(``repro.launch.serve``'s flat ``submit`` form).

    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --high qwen3-4b --low mamba2-2.7b --mode fikit --requests 8

Any ported config can take either role: the dense qwen3-4b,
stablelm-1.6b and granite-20b, the mamba2-2.7b SSM, or the
recurrentgemma-9b hybrid, served as ``rec`` and ``attn`` block segments.
The default pair, qwen3-4b over mamba2-2.7b, is pair A of the paper's
Fig 16; ``--low granite-20b`` is pair B and ``--low recurrentgemma-9b``
pair E. ``--full`` runs the published widths and depths (random
weights); without it the services run at ``.reduced()`` scale, where
mamba2's SSD chunk (32) must divide the sequence length (48 here, as in
the JAX package, so the reduced default pair stops there: pass another
``--low``).
``--device`` picks the torch device (default ``cuda``; there is no
fallback to the CPU). The durable ops-plane verbs, ``--resume`` and the
``load`` verb come in a later slice.
"""
from __future__ import annotations

import argparse
import statistics as st

from repro_torch.core.policy import Mode
from repro_torch.core.queues import QUEUE_DISCIPLINES


def serve_pair(high: str, low: str, mode: str = "fikit", requests: int = 8,
               measure_runs: int = 4, batch: int = 2, seq: int = 48,
               host_gap: float = 0.002, devices: int = 1,
               discipline: str = "fifo", deadline: float = None,
               online_measure: bool = False, reduced: bool = True,
               device="cuda", verbose: bool = True):
    """Host a high/low priority service pair on the wall-clock engine.

    ``discipline`` is the intra-device queue discipline ("fifo"/"sjf"/
    "edf"); ``deadline`` optionally gives every LOW-priority invocation a
    relative completion budget in seconds. ``online_measure`` keeps
    refining SK/SG live during the sharing phase: the LOW service is then
    NOT onboarded offline — it starts cold and becomes gap-fillable from
    its own observed kernels. ``reduced=False`` serves the configs at
    their published sizes. The low service runs at twice the high one's
    batch: ``serve_pair("qwen3-4b", "recurrentgemma-9b", reduced=False)``
    serves pair E with the hybrid at batch 4, seq 48."""
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceService, ServingSystem

    def cfg(name):
        c = get_config(name)
        return c.reduced() if reduced else c

    hi = InferenceService(cfg(high), priority=0, batch=batch, seq=seq,
                          host_gap=host_gap, device=device)
    lo = InferenceService(cfg(low), priority=5, batch=batch * 2, seq=seq,
                          device=device)
    with ServingSystem(Mode(mode), measure_runs=measure_runs,
                       devices=devices, queue_discipline=discipline,
                       online_measure=online_measure) as sys_:
        meas_hi = sys_.onboard(hi)
        if online_measure:
            lo.svc.warmup()            # build outside the timed phase
            meas_lo = []
        else:
            meas_lo = sys_.onboard(lo)
        res = sys_.invoke_concurrent([
            ("high", hi, requests, 0.0, 0.01),
            ("low", lo, requests, 0.0, 0.0, deadline),
        ])
        fills = sys_.engine.fill_count
        steals = sys_.engine.steal_count
        misses = sys_.deadline_misses
        tagged = sys_.deadlines_tagged
    # read AFTER the context closes: stop() flushes the final partial epoch
    online_stats = sys_.online_stats
    out = {
        "mode": mode,
        "devices": devices,
        "discipline": discipline,
        "online_measure": online_measure,
        "measure_high_ms": 1e3 * st.mean(meas_hi),
        "measure_low_ms": 1e3 * st.mean(meas_lo) if meas_lo else 0.0,
        "high_jct_ms": 1e3 * st.mean(res["high"]),
        "low_jct_ms": 1e3 * st.mean(res["low"]),
        "high_jct_cv": (st.pstdev(res["high"]) / st.mean(res["high"])),
        "low_jct_cv": (st.pstdev(res["low"]) / st.mean(res["low"])),
        "fills": fills,
        "steals": steals,
        "deadline_misses": misses,
        "deadlines_tagged": tagged,
    }
    if online_stats is not None:
        out["online_observations"] = online_stats["observations"]
        out["online_commits"] = online_stats["commits"]
        out["online_cold_observations"] = online_stats["cold_observations"]
        out["online_drift_rel_err"] = round(
            online_stats["drift_mean_rel_err"], 4)
    if verbose:
        for k, v in out.items():
            print(f"  {k}: {v if isinstance(v, (str, int)) else round(v, 3)}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--high", default="qwen3-4b")
    ap.add_argument("--low", default="mamba2-2.7b")
    ap.add_argument("--mode", default="fikit",
                    choices=[m.value for m in Mode])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--devices", type=int, default=1,
                    help="number of device executors (placement layer)")
    ap.add_argument("--discipline", default="fifo",
                    choices=sorted(QUEUE_DISCIPLINES),
                    help="intra-device queue discipline")
    ap.add_argument("--deadline", type=float, default=None,
                    help="relative completion budget (s) tagged onto "
                         "low-priority invocations")
    ap.add_argument("--online-measure", action="store_true",
                    help="refine SK/SG live during the sharing phase; the "
                         "low-priority service is NOT onboarded offline")
    ap.add_argument("--device", default="cuda",
                    help="torch device the services run on")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths and depths instead "
                         "of the .reduced() configs")
    args = ap.parse_args(argv)
    serve_pair(args.high, args.low, args.mode, args.requests,
               devices=args.devices, discipline=args.discipline,
               deadline=args.deadline, online_measure=args.online_measure,
               reduced=not args.full, device=args.device)


if __name__ == "__main__":
    main()
