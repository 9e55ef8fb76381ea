"""Find a cell's knee: the highest Poisson rate of high requests that holds
without a growing backlog while the cell's low backlog runs.

    python3 servebench/knee.py --workload F.fill --seed 11 --seconds 20 \\
        --rates 2,3,4,5,6

One process sets the cell up once, then runs one window per rate (the
mix's arrivals at that rate, its low backlog as in a run; ``--set
low.seq=128`` changes a value of the mix for a trial) and prints a
JSON line per rate: requests, p50 and p90 from the due time, the median
latency of the window's last third over its first third (above 1.5 the
queue grew), and the low service's tokens per second. The mix's rate is
then written by hand as a fraction of the knee.
"""
import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--set", nargs="*", default=[],
                    help="mix values to change, as path=number")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.serving.admission import COMPLETED
    from servebench import harness, stats, traffic

    cell = harness.load_cell(args.workload)
    for item in args.set:
        path, value = item.split("=")
        *outer, key = path.split(".")
        node = cell.mix
        for k in outer:
            node = node[k]
        node[key] = float(value) if "." in value else int(value)
    mix, cfgs, _, _, _, services, system = harness.build(
        cell, args.seed, args.device)
    rates = [float(r) for r in args.rates.split(",")]
    mh, ml = mix["high"], mix["low"]
    most = len(traffic.open_loop({"kind": "poisson",
                                  "rate_per_s": max(rates)},
                                 args.seconds, args.seed)) * 2
    hi_prompts = traffic.prompts(args.seed, "high", most, mh["batch"],
                                 mh["seq"], cfgs["high"].vocab_size,
                                 args.device)
    lo_prompts = traffic.prompts(args.seed, "low", traffic.LOW_PROMPTS,
                                 ml["batch"], ml["seq"],
                                 cfgs["low"].vocab_size, args.device)
    system.start()
    try:
        harness._bound_records(system)
        excl = {}
        for role in harness.ROLES:
            excl[role] = statistics.median(
                system.onboard(services[role]))
        for role in harness.ROLES:
            s = services[role]
            t = harness.submit(system, s, mix[role]["qos"], s.svc._warm,
                               time.perf_counter())
            assert t.result(timeout=harness.LATE_S) == COMPLETED
        print(json.dumps({"set": args.set, "exclusive_ms": {
            r: 1e3 * v for r, v in excl.items()}, "sk_sg_ms": {
            r: {k.name.rsplit("/", 1)[-1]: [1e3 * v, 1e3 * system.profiles.get(
                services[r].key).SG.get(k, 0.0)]
                for k, v in system.profiles.get(services[r].key).SK.items()}
            for r in harness.ROLES}}), flush=True)
        for rate in rates:
            step = copy.deepcopy(mix)
            step["high"]["arrivals"]["rate_per_s"] = rate
            times = traffic.open_loop(step["high"]["arrivals"],
                                      args.seconds, args.seed)
            run = harness.Run(cell, cfgs, args.seconds)
            harness.drive(run, system, services, step, times, hi_prompts,
                          lo_prompts)
            lat = [(r.done - r.sent) if r.done is not None else
                   float("inf") for r in run.high]
            third = max(1, len(lat) // 3)
            trend = (statistics.median(lat[-third:])
                     / statistics.median(lat[:third]))
            print(json.dumps({
                "rate_per_s": rate, "requests": len(lat),
                "missing": sum(1 for r in run.high if r.done is None),
                "hi_p50_ms": stats.latency_ms(run, "high", 0.5),
                "hi_p90_ms": stats.latency_ms(run, "high", 0.9),
                "last_over_first_third": trend,
                "lo_tokens_per_s": (ml["batch"] * ml["seq"]
                                    * len(run.completed_in_window("low"))
                                    / args.seconds),
                "fills": run.fills, "gen_lag_ms": 1e3 * run.gen_lag_s}),
                flush=True)
    finally:
        system.stop()
    if torch.cuda.is_available():
        print(f"card: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
