"""The port's copy of the cluster-scale simulator (``repro_torch.sim``,
the JAX package's ``repro.sim`` with the import prefix turned, pinned in
``tests/test_torch_core_copy.py``) gives the reports of the reference:
seeded workloads (periodic task sets, sporadic releases, Poisson and
diurnal traces) through each package's own workload generator, fast
event core, fleet runner (inline and in a process pool) and analytics.
Neither package runs a model here, so the test needs neither JAX nor
torch."""
import importlib

import pytest


def _pkg(root):
    mods = {}
    for name in ("sim.workload", "sim.fleet", "sim.analytics",
                 "core.scheduler", "core.policy", "core.task",
                 "core.kernel_id"):
        mods[name.split(".")[1]] = importlib.import_module(f"{root}.{name}")
    return mods


PKGS = ("repro", "repro_torch")


def _report(rep):
    """A SimReport as plain values."""
    return {
        "results": [(r.arrival, r.start, r.completion)
                    for r in rep.results],
        "timeline": sorted((k.task, k.seq, k.start, k.end, k.filler,
                            k.device) for k in rep.timeline),
        "fills": rep.fills, "steals": rep.steals, "events": rep.events,
        "misses": (rep.deadline_misses, rep.deadlines_tagged),
        "busy": rep.device_busy(),
    }


def _jobs(m, seed, sporadic=False):
    ts = m["workload"].periodic_taskset(18, 4.5, seed=seed,
                                        phase_jitter=0.3)
    return m["workload"].release_jobs(ts, cycles=2, sporadic=sporadic,
                                      seed=seed)


@pytest.mark.parametrize("sporadic", [False, True], ids=["periodic",
                                                         "sporadic"])
@pytest.mark.parametrize("mode", ["FIKIT", "PREEMPT", "SHARING"])
@pytest.mark.parametrize("K", [1, 3])
def test_fast_core_reports_are_identical(K, mode, sporadic):
    out = {}
    for root in PKGS:
        m = _pkg(root)
        jobs = _jobs(m, seed=11 * K, sporadic=sporadic)
        sim = m["scheduler"].SimScheduler(
            jobs, getattr(m["policy"].Mode, mode), devices=K, jitter=0.02,
            seed=3, trace="list")
        rep = sim.run()
        out[root] = (_report(rep), [list(p.trace) for p in
                                    sim.placement.policies],
                     m["analytics"].fleet_summary(jobs, rep))
    assert out["repro"] == out["repro_torch"]
    assert out["repro"][0]["results"] and out["repro"][0]["timeline"]


@pytest.mark.parametrize("workers", [1, 2], ids=["inline", "pool"])
@pytest.mark.parametrize("discipline", ["round_robin", "priority_affinity"])
def test_fleet_reports_are_identical(discipline, workers):
    out = {}
    for root in PKGS:
        m = _pkg(root)
        jobs = _jobs(m, seed=5)
        fl = m["fleet"].simulate_fleet(
            jobs, m["policy"].Mode.FIKIT, devices=4, discipline=discipline,
            workers=workers, trace="list", record_timeline=True)
        out[root] = (_report(fl.report), fl.traces, fl.device_of, fl.shards,
                     m["analytics"].fleet_summary(jobs, fl.report))
    assert out["repro"] == out["repro_torch"]
    assert out["repro"][0]["timeline"] and out["repro"][1]


@pytest.mark.parametrize("kind", ["poisson", "diurnal"])
def test_arrival_traces_are_identical(kind):
    out = {}
    for root in PKGS:
        m = _pkg(root)
        kid = m["kernel_id"].KernelID("svc/layer", (1,), (2,))
        tpl = m["task"].TaskSpec(
            m["task"].TaskKey("svc", (0,)), 2,
            [m["task"].TraceKernel(kid, duration=2e-3, gap_after=1e-3)] * 3)
        gen = getattr(m["workload"], f"{kind}_trace")
        jobs = gen(tpl, 40.0, 2.0, seed=9, deadline=0.05)
        rep = m["scheduler"].SimScheduler(
            jobs, m["policy"].Mode.FIKIT, devices=2).run()
        out[root] = ([(j.key.args, j.arrival, j.deadline) for j in jobs],
                     _report(rep), m["analytics"].jct_stats(
                         [r.completion - r.arrival for r in rep.results]))
    assert out["repro"] == out["repro_torch"]
    assert len(out["repro"][0]) > 20
