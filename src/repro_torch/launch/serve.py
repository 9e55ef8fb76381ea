"""Serving entry point: hosts a high/low priority service pair on the FIKIT
engine with batched requests — the end-to-end serving path of the port
(``repro.launch.serve``) — plus the ops plane's operator CLI.

    # serve (the flat form still works — "submit" is the default verb):
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --high qwen3-4b --low mamba2-2.7b --mode fikit --requests 8

    # durable serving + crash recovery:
    ... serve submit --full --jobstore build/fikit.db --resume

    # operator verbs against a live serving process sharing the store
    # (each enqueues a control row the server's poller consumes; status
    # reads the store directly and needs no live server):
    ... serve status --jobstore build/fikit.db
    ... serve cancel 3 --jobstore build/fikit.db
    ... serve pause  3 --jobstore build/fikit.db
    ... serve resume 3 --jobstore build/fikit.db --device 1
    ... serve drain    --jobstore build/fikit.db

    # open-loop traffic through the admission plane (Poisson arrivals,
    # optionally diurnal-modulated low-priority; per-QoS-class latency,
    # goodput, shed/reject counts):
    ... serve load --full --high qwen3-4b --low mamba2-2.7b \
        --rate 2 --duration 8 --deadline 0.5 --diurnal

    # the multi-process worker fleet over one store (no model runs):
    ... serve workers run -n 2 --jobstore build/fikit.db
    ... serve workers status --jobstore build/fikit.db

Any ported config can take either role: the dense qwen3-4b,
stablelm-1.6b, granite-20b and h2o-danube-3-4b, the mamba2-2.7b SSM,
the recurrentgemma-9b hybrid (served as ``rec`` and ``attn`` block
segments), the seamless-m4t-medium encoder-decoder (``encode``, then
``dec_layer`` segments) or the llava-next-mistral-7b VLM. The default
pair, qwen3-4b over mamba2-2.7b, is pair A of the paper's Fig 16;
``--low granite-20b`` is pair B and ``--low recurrentgemma-9b`` pair E;
``--high stablelm-1.6b --low h2o-danube-3-4b`` is pair F and ``--high
seamless-m4t-medium --low llava-next-mistral-7b`` pair J. ``--full`` runs the published widths and depths (random
weights); without it the services run at ``.reduced()`` scale, where
mamba2's SSD chunk (32) must divide the sequence length (48 under
``submit``, as in the JAX package, so the reduced default pair stops
there: pass another ``--low``; ``load`` serves seq 32, which it
divides). ``--device`` picks the torch device of the verbs that run a
model (default ``cuda``; there is no fallback to the CPU).
"""
from __future__ import annotations

import argparse
import random
import statistics as st
import sys as _sys

from repro_torch.core.jobstore import JobStore
from repro_torch.core.queues import QUEUE_DISCIPLINES
from repro_torch.core.scheduler import Mode
from repro_torch.serving.loadgen import (diurnal_arrivals, merge_schedules,
                                         poisson_arrivals, replay)

# NOTE: repro_torch.serving engine / repro_torch.config imports (which
# pull in torch and the model zoo) happen inside the commands that run
# models — the pure-store verbs (status, controls, workers) must start in
# milliseconds.


def _services(high: str, low: str, reduced: bool, device, hi_kw: dict,
              lo_kw: dict):
    """The high (Q0) and low (Q5) ``InferenceService`` of a pair, at the
    published sizes unless ``reduced``."""
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceService

    def cfg(name):
        c = get_config(name)
        return c.reduced() if reduced else c

    return (InferenceService(cfg(high), priority=0, device=device, **hi_kw),
            InferenceService(cfg(low), priority=5, device=device, **lo_kw))


def serve_pair(high: str, low: str, mode: str = "fikit", requests: int = 8,
               measure_runs: int = 4, batch: int = 2, seq: int = 48,
               host_gap: float = 0.002, devices: int = 1,
               discipline: str = "fifo", deadline: float = None,
               online_measure: bool = False,
               jobstore: str = None, resume: bool = False,
               reduced: bool = True, device="cuda", verbose: bool = True):
    """Host a high/low priority service pair on the wall-clock engine.

    ``discipline`` is the intra-device queue discipline ("fifo"/"sjf"/
    "edf"); ``deadline`` optionally gives every LOW-priority invocation a
    relative completion budget in seconds. ``online_measure`` keeps
    refining SK/SG live during the sharing phase: the LOW service is then
    NOT onboarded offline — it starts cold and becomes gap-fillable from
    its own observed kernels. ``reduced=False`` serves the configs at
    their published sizes. The low service runs at twice the high one's
    batch: ``serve_pair("qwen3-4b", "recurrentgemma-9b", reduced=False)``
    serves pair E with the hybrid at batch 4, seq 48.

    ``jobstore`` attaches the durable ops plane (a SQLite path): every
    invocation is recorded write-ahead and the operator verbs
    (cancel/pause/resume/drain, see ``main``) act on this run through
    the shared store; ``resume=True`` first re-runs every invocation a
    previous (killed) run left incomplete in the store."""
    from repro_torch.serving import ServingSystem
    hi, lo = _services(high, low, reduced, device,
                       dict(batch=batch, seq=seq, host_gap=host_gap),
                       dict(batch=batch * 2, seq=seq))
    with ServingSystem(Mode(mode), measure_runs=measure_runs,
                       devices=devices, queue_discipline=discipline,
                       online_measure=online_measure,
                       jobstore=jobstore) as sys_:
        meas_hi = sys_.onboard(hi)
        if online_measure:
            lo.svc.warmup()            # build outside the timed phase
            meas_lo = []
        else:
            meas_lo = sys_.onboard(lo)
        recovered = sys_.recover([hi, lo]) if (resume and jobstore) else []
        res = sys_.invoke_concurrent([
            ("high", hi, requests, 0.0, 0.01),
            ("low", lo, requests, 0.0, 0.0, deadline),
        ])
        fills = sys_.engine.fill_count
        steals = sys_.engine.steal_count
        misses = sys_.deadline_misses
        tagged = sys_.deadlines_tagged
        cancelled = sys_.cancelled_invocations
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
        "cancelled_invocations": cancelled,
    }
    if jobstore is not None:
        out["jobstore"] = jobstore
        out["recovered_jobs"] = len(recovered)
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


def serve_load(high: str, low: str, mode: str = "fikit",
               rate: float = 20.0, duration: float = 2.0,
               hi_share: float = 0.3, deadline: float = None,
               diurnal: bool = False, speed: float = 1.0,
               measure_runs: int = 3, devices: int = 1, seed: int = 0,
               reduced: bool = True, device="cuda", verbose: bool = True):
    """Open-loop traffic through the admission plane: the high service
    maps to the ``gold`` QoS class (FIKIT Q0), the low service to
    ``bronze`` (Q5). Arrivals are drawn up front (Poisson at ``rate``
    req/s total, split by ``hi_share``; ``diurnal=True`` modulates the
    bronze rate sinusoidally) and replayed without ever waiting on
    completions — offered load is independent of service capacity, so
    pushing ``rate`` past capacity exercises backpressure (rejects) and,
    with ``deadline`` set, SLO shedding. The measurement phase's JCTs
    prime the plane's service-time EMA, so shedding is informed from the
    first request. ``reduced=False`` serves the published sizes on
    ``device``; gold runs batch 1, bronze batch 2, both at seq 32."""
    from repro_torch.serving import QoSClass, ServingSystem
    hi, lo = _services(high, low, reduced, device, dict(batch=1, seq=32),
                       dict(batch=2, seq=32))
    classes = (QoSClass("gold", priority=0, queue_limit=64,
                        deadline=deadline, max_batch=4),
               QoSClass("bronze", priority=5, queue_limit=256,
                        deadline=None, max_batch=8))
    rng = random.Random(seed)
    with ServingSystem(Mode(mode), measure_runs=measure_runs,
                       devices=devices,
                       admission={"classes": classes}) as sys_:
        meas_hi = sys_.onboard(hi)
        meas_lo = sys_.onboard(lo)
        sys_.admission.note_latency(hi, st.mean(meas_hi))
        sys_.admission.note_latency(lo, st.mean(meas_lo))
        gen_lo = diurnal_arrivals if diurnal else poisson_arrivals
        sched = merge_schedules(
            poisson_arrivals(rate * hi_share, duration, hi, "gold", rng),
            gen_lo(rate * (1 - hi_share), duration, lo, "bronze", rng))
        rep = replay(sys_.admission, sched, speed=speed,
                     keep_tickets=False)
        sys_.admission.drain(timeout=120)
        stats = sys_.admission.stats()
    out = {
        "mode": mode,
        "offered": rep.offered,
        "rate_rps": rate,
        "wall_s": round(rep.wall_s, 3),
        "feeder_lag_max_ms": round(1e3 * rep.lag_max_s, 2),
        "priority_inversions": stats["priority_inversions"],
    }
    for cname, s in stats["classes"].items():
        out[f"{cname}_offered"] = s["offered"]
        out[f"{cname}_completed"] = s["completed"]
        out[f"{cname}_rejected"] = s["rejected"]
        out[f"{cname}_shed"] = s["shed"]
        out[f"{cname}_p50_ms"] = round(s["p50_ms"], 2)
        out[f"{cname}_p99_ms"] = round(s["p99_ms"], 2)
        out[f"{cname}_goodput"] = round(s["goodput"], 4)
    if verbose:
        for k, v in out.items():
            print(f"  {k}: {v}")
    return out


#: CLI verbs; anything else as the first argv token means the legacy
#: flat form, which is rewritten to ``submit`` for back-compat
VERBS = ("submit", "load", "status", "cancel", "pause", "resume", "drain",
         "workers")

#: Sub-verbs of ``workers`` (the multi-process fleet surface).
WORKER_VERBS = ("run", "status", "stop")


def _cmd_submit(args) -> None:
    serve_pair(args.high, args.low, args.mode, args.requests,
               devices=args.devices, discipline=args.discipline,
               deadline=args.deadline, online_measure=args.online_measure,
               jobstore=args.jobstore, resume=args.resume,
               reduced=not args.full, device=args.device)


def _cmd_status(args) -> None:
    with JobStore(args.jobstore) as store:
        jobs = store.jobs()
        if not jobs:
            print("no jobs in store")
            return
        print(f"{'job':>5} {'process':<24} {'prio':>4} {'state':<10} "
              f"{'done':>5} {'total':>5}")
        for j in jobs:
            print(f"{j.job_id:>5} {j.key.process:<24} {j.priority:>4} "
                  f"{j.state:<10} {j.completed:>5} {j.n_kernels:>5}")


def _cmd_control(verb: str, args) -> None:
    """Enqueue an operator verb for the serving process sharing the
    store file; it is applied at the next poller tick (a kernel-boundary
    action on the engine side)."""
    job_id = getattr(args, "job", None)
    arg = None
    if verb == "resume" and args.device is not None:
        arg = str(args.device)
    with JobStore(args.jobstore) as store:
        store.request_control(verb, job_id, arg=arg)
    target = f" for job {job_id}" if job_id is not None else ""
    print(f"queued {verb}{target} in {args.jobstore}")


def _add_store_arg(p, required=True) -> None:
    p.add_argument("--jobstore", required=required,
                   help="path of the durable job store (SQLite)")


def _add_model_args(p) -> None:
    """The options of every verb that runs a model: the pair, the mode,
    the scale and the torch device."""
    p.add_argument("--high", default="qwen3-4b")
    p.add_argument("--low", default="mamba2-2.7b")
    p.add_argument("--mode", default="fikit",
                   choices=[m.value for m in Mode])
    p.add_argument("--device", default="cuda",
                   help="torch device the services run on")
    p.add_argument("--full", action="store_true",
                   help="serve the published widths and depths instead "
                        "of the .reduced() configs")


def _cmd_workers(args) -> None:
    """The fleet surface: ``workers run`` spawns N worker processes
    over one store and drains it; ``workers status`` aggregates the
    fleet view (per-worker goodput, per-class JCT, lease churn);
    ``workers stop`` requests a graceful drain (each worker finishes
    its current batch, then exits)."""
    import json as _json

    from repro_torch.serving.workers import WorkerSupervisor, fleet_status
    if args.wverb == "run":
        sup = WorkerSupervisor(args.jobstore, n=args.n, mode=args.mode,
                               lease_s=args.lease,
                               heartbeat_s=args.heartbeat,
                               batch=args.batch, pace_s=args.pace,
                               shard=args.shard)
        sup.start()
        try:
            summaries = sup.wait(timeout=args.timeout)
        finally:
            sup.kill()
        for s in summaries:
            print(f"  {s['worker_id']}: jobs={s['jobs_done']} "
                  f"kernels={s['kernels_done']} steals={s['steals']} "
                  f"batches={s['batches']}")
    with JobStore(args.jobstore) as store:
        if args.wverb == "stop":
            store.set_flag("workers_stop", "1")
            print(f"queued fleet stop in {args.jobstore}")
            return
        fs = fleet_status(store)
    if getattr(args, "json", False):
        print(_json.dumps(fs, indent=2))
        return
    print(f"{'worker':<10} {'state':<9} {'jobs':>5} {'kernels':>8} "
          f"{'steals':>6} {'reaped':>6} {'goodput/s':>10}")
    for w in fs["workers"]:
        print(f"{w['worker_id']:<10} {w['state']:<9} {w['jobs_done']:>5} "
              f"{w['kernels_done']:>8} {w['steals']:>6} {w['reaped']:>6} "
              f"{w['goodput_kps']:>10.1f}")
    for name, c in fs["classes"].items():
        print(f"  class {name}: jobs={c['jobs']} "
              f"jct_p50={c['jct_p50']:.3f}s jct_p99={c['jct_p99']:.3f}s")
    print(f"  pending={fs['pending']} leased={fs['leased']} "
          f"lease_churn={fs['lease_churn']}")


def parse_args(argv=None) -> argparse.Namespace:
    """Parse a command line; a first token that is no verb is the legacy
    flat form, rewritten to ``submit``."""
    argv = list(_sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in VERBS + ("-h", "--help"):
        argv.insert(0, "submit")       # legacy flat form

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    sub = ap.add_subparsers(dest="verb", required=True)

    sp = sub.add_parser("submit", help="host a high/low service pair")
    _add_model_args(sp)
    sp.add_argument("--requests", type=int, default=8)
    sp.add_argument("--devices", type=int, default=1,
                    help="number of device executors (placement layer)")
    sp.add_argument("--discipline", default="fifo",
                    choices=sorted(QUEUE_DISCIPLINES),
                    help="intra-device queue discipline")
    sp.add_argument("--deadline", type=float, default=None,
                    help="relative completion budget (s) tagged onto "
                         "low-priority invocations (edf ordering + "
                         "deadline_misses stat)")
    sp.add_argument("--online-measure", action="store_true",
                    help="refine SK/SG live during the sharing phase "
                         "(EMA epoch commits + cold-start predictions); "
                         "the low-priority service is NOT onboarded "
                         "offline and learns its profile online")
    _add_store_arg(sp, required=False)
    sp.add_argument("--resume", action="store_true",
                    help="first re-run invocations a previous run left "
                         "incomplete in the jobstore")

    lp = sub.add_parser("load", help="open-loop Poisson/diurnal traffic "
                                     "through the admission plane")
    _add_model_args(lp)
    lp.add_argument("--rate", type=float, default=20.0,
                    help="total offered request rate (req/s)")
    lp.add_argument("--duration", type=float, default=2.0,
                    help="schedule length (s)")
    lp.add_argument("--hi-share", type=float, default=0.3,
                    help="fraction of offered load in the gold class")
    lp.add_argument("--deadline", type=float, default=None,
                    help="gold-class SLO budget (s); enables SLO-aware "
                         "shedding")
    lp.add_argument("--diurnal", action="store_true",
                    help="modulate the bronze rate sinusoidally")
    lp.add_argument("--speed", type=float, default=1.0,
                    help="replay speedup (2.0 = twice as fast)")
    lp.add_argument("--devices", type=int, default=1)
    lp.add_argument("--seed", type=int, default=0)

    st_ = sub.add_parser("status", help="print the store's job table")
    _add_store_arg(st_)

    wp = sub.add_parser("workers", help="multi-process worker fleet "
                                        "over one job store")
    wsub = wp.add_subparsers(dest="wverb", required=True)
    wr = wsub.add_parser("run", help="spawn N workers and drain the "
                                     "store's submitted jobs")
    wr.add_argument("-n", type=int, default=2, help="worker processes")
    wr.add_argument("--mode", default="fikit",
                    choices=[m.value for m in Mode])
    wr.add_argument("--batch", type=int, default=16,
                    help="max jobs per claimed batch")
    wr.add_argument("--pace", type=float, default=0.0,
                    help="wall seconds slept per kernel completion "
                         "(0 = replay at store speed)")
    wr.add_argument("--lease", type=float, default=5.0,
                    help="claim lease duration (s); crashed workers' "
                         "jobs are reclaimed after expiry")
    wr.add_argument("--heartbeat", type=float, default=1.0,
                    help="lease renewal period (s)")
    wr.add_argument("--shard", action="store_true",
                    help="partition the store's qos shard keys across "
                         "workers (with any-shard stealing) instead of "
                         "one shared queue")
    wr.add_argument("--timeout", type=float, default=300.0)
    _add_store_arg(wr)
    ws = wsub.add_parser("status", help="aggregated fleet status: "
                                        "per-worker goodput, per-class "
                                        "JCT, lease churn")
    ws.add_argument("--json", action="store_true",
                    help="machine-readable output")
    _add_store_arg(ws)
    wx = wsub.add_parser("stop", help="graceful fleet drain (workers "
                                      "finish their batch, then exit)")
    _add_store_arg(wx)
    for verb, jobbed in (("cancel", True), ("pause", True),
                         ("resume", True), ("drain", False)):
        vp = sub.add_parser(verb, help=f"queue a {verb} for the live "
                                       f"serving process on this store")
        if jobbed:
            vp.add_argument("job", type=int, help="job id (see status)")
        if verb == "resume":
            vp.add_argument("--device", type=int, default=None,
                            help="pin the resumed task to this device")
        _add_store_arg(vp)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.verb == "submit":
        _cmd_submit(args)
    elif args.verb == "load":
        serve_load(args.high, args.low, args.mode, rate=args.rate,
                   duration=args.duration, hi_share=args.hi_share,
                   deadline=args.deadline, diurnal=args.diurnal,
                   speed=args.speed, devices=args.devices, seed=args.seed,
                   reduced=not args.full, device=args.device)
    elif args.verb == "status":
        _cmd_status(args)
    elif args.verb == "workers":
        _cmd_workers(args)
    else:
        _cmd_control(args.verb, args)


if __name__ == "__main__":
    main()
