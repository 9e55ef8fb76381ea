"""One run of a cell: two services on one card under FIKIT, driven
through the port's admission plane, then the outputs check.

A cell (``cells/<cell>.json``) names a configuration (``configs/``: the
two models, each with the port's fields as run and its reference) and a
mix (``mixes/``: shapes, host gaps, arrivals, backlog). The metrics a
run reports are those ``BENCHMARK.json`` lists for the cell, each read by
its own module, ``metrics/<name>.py`` (``read(run) -> value or None``).
Adding a cell, a configuration, a mix or a metric adds files; nothing
here names one.

The system under test is the port's ``ServingSystem(Mode.FIKIT)`` with
its ``AdmissionPlane``: the high service in the mix's open-loop class,
the low one as a closed-loop backlog. The benchmark builds the services
from the port's own ``SegmentedService`` over weights it made itself,
and wraps each segment (``Served``) so that a request carries its id
beside the state: the request's own prompt goes in, the logits of the
sampled requests come out, and every segment call and host step leaves a
span. Those wrappers add a tuple and a clock read per segment.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.client import Segment
from repro_torch.core.scheduler import Mode
from repro_torch.core.task import TaskKey
from repro_torch.models import api
from repro_torch.models.layers import torch_dtype
from repro_torch.models.segmentation import SegmentedService
from repro_torch.serving.admission import COMPLETED, REJECTED, QoSClass
from repro_torch.serving.engine import InferenceService, ServingSystem

from servebench import traffic, weights as wt
from servebench.catalog import (Cell, benchmark_entries, load_cell,
                                load_metric, load_reference)
from servebench.compare import logit_gap
from servebench.reference.arith import Arith
from servebench.trace import Tracer

HERE = Path(__file__).resolve().parent
ROLES = ("high", "low")
#: how long past the window's close a request may still come back
LATE_S = 60.0
#: the low backlog starts this long before the window, so it is running
#: when the window opens
LEAD_S = 0.5


def port_config(model: dict, **override) -> ModelConfig:
    """The port's ``ModelConfig`` as the configuration file runs it."""
    cfg = ModelConfig(**model["port"])
    return cfg.replace(**override) if override else cfg


# ------------------------------------------------------------- services
class Served:
    """The port's segments of one service, each wrapped: a request's state
    is (tensor, request id); the head keeps the logits of the ids
    ``keeps`` accepts (by default those in ``keep``); every call logs
    (name, start_ns, end_ns) into ``spans``. ``in_high`` counts the high
    requests between their first segment and their head: the low
    service's ``fills`` counts, by request, its layers run meanwhile, in
    the gaps of a high request."""

    def __init__(self, role: str, svc: SegmentedService, spans: list,
                 warm_tokens: torch.Tensor, in_high: list):
        self.role = role
        self.svc = svc
        self.spans = spans
        self.pending: collections.deque = collections.deque()
        self.keep: set = set()
        self.keeps: Callable[[int], bool] = self.keep.__contains__
        self.kept: Dict[int, torch.Tensor] = {}
        self.fills: Dict[int, int] = collections.Counter()
        self.in_high = in_high
        self.onboarding = True
        self._warm = (warm_tokens, -1)
        last = len(svc.segments) - 1
        self.segments = [self._wrap(s, i == 0, i == last)
                         for i, s in enumerate(svc.segments)]

    def _wrap(self, seg, is_first: bool, is_head: bool):
        name = f"{self.role}/{seg.name.rsplit('/', 1)[-1]}"
        fn, host, spans, kept = (seg.fn, seg.host_work, self.spans,
                                 self.kept)
        high, in_high, fills = self.role == "high", self.in_high, self.fills
        is_layer = not (is_first or is_head)

        def run(state):
            x, rid = state
            if high and is_first:
                in_high[0] += 1
            elif is_layer and not high and in_high[0] > 0:
                fills[rid] += 1
            t0 = time.perf_counter_ns()
            y = fn(x)
            spans.append((name, t0, time.perf_counter_ns()))
            if not is_head:
                return y, rid
            if high:
                in_high[0] -= 1
            if self.keeps(rid):
                kept[rid] = y
            return y

        work = None
        if host is not None:
            step = name + (".sample" if is_head else ".gap")

            def work(state):
                t0 = time.perf_counter_ns()
                out = host(state)
                spans.append((step, t0, time.perf_counter_ns()))
                return out
        return Segment(seg.name, run, host_work=work)

    def make_input(self):
        if self.pending:
            return self.pending.popleft()
        if self.onboarding:
            return self._warm
        raise RuntimeError(f"{self.role}: a request was dispatched with no "
                           f"prompt queued for it")

    def warmup(self):
        state = self._warm
        for seg in self.segments:
            state = seg.fn(state)
        return True


class BenchService(InferenceService):
    """An ``InferenceService`` whose model holds the benchmark's weights
    and whose segments are ``Served``'s."""

    def __init__(self, role: str, cfg: ModelConfig, params: dict,
                 mix_role: dict, spans: list, warm_tokens: torch.Tensor,
                 in_high: list):
        self.cfg = cfg
        self.priority = mix_role["priority"]
        B, S = mix_role["batch"], mix_role["seq"]
        self.key = TaskKey(cfg.name, (B, S))
        model = api.build_params(cfg, 0, "meta")
        wt.load_into(model, params)
        svc = SegmentedService(cfg, model, B, S,
                               host_gap=mix_role["host_gap_ms"] * 1e-3)
        self.svc = Served(role, svc, spans, warm_tokens, in_high)
        self.profiled = False


# ----------------------------------------------------------------- runs
@dataclass
class Request:
    rid: int
    sent: float                 # due time (high) or submit time (low)
    ticket: object = None

    @property
    def done(self) -> Optional[float]:
        t = self.ticket
        if t is None or t.outcome != COMPLETED:
            return None
        return t.arrival + t.latency


@dataclass
class Run:
    """What a run leaves for the metric readers."""
    cell: Cell
    cfgs: Dict[str, ModelConfig]
    seconds: float
    t0: float = 0.0                 # window, perf_counter seconds
    setup_s: float = 0.0
    high: List[Request] = field(default_factory=list)
    low: List[Request] = field(default_factory=list)
    gen_lag_s: float = 0.0
    fills: int = 0
    spans: List[tuple] = field(default_factory=list)   # (name, s, s)
    profiles: Dict[str, object] = field(default_factory=dict)
    #: layers of each checked low request run in a high request's gaps
    low_fills: Dict[int, int] = field(default_factory=dict)
    trace: object = None

    @property
    def t1(self) -> float:
        return self.t0 + self.seconds

    def shape(self, role: str):
        m = self.cell.mix[role]
        return m["batch"], m["seq"]

    def cfg(self, role: str) -> dict:
        return dataclasses.asdict(self.cfgs[role])

    def completed_in_window(self, role: str) -> List[Request]:
        return [r for r in getattr(self, role)
                if r.done is not None and self.t0 <= r.done <= self.t1]

    def window_spans(self, prefix: str) -> List[tuple]:
        return [s for s in self.spans
                if s[0].startswith(prefix) and self.t0 <= s[1] <= self.t1]


def build(cell: Cell, seed: int, device, cfg_override=None,
          mix_override=None):
    """Weights, services and the serving system of one run (set-up)."""
    mix = cell.mix if mix_override is None else mix_override
    dev = torch.device(device)
    cfgs, refs, params = {}, {}, {}
    for role in ROLES:
        model = cell.config[role]
        cfgs[role] = port_config(model, **(cfg_override or {}).get(role, {}))
        refs[role] = load_reference(model["reference"])
        params[role] = wt.make(
            refs[role].param_specs(dataclasses.asdict(cfgs[role])),
            wt.generator(seed, role, dev), torch_dtype(cfgs[role].dtype),
            dev)
    spans: list = []
    in_high = [0]
    services = {}
    for role in ROLES:
        m = mix[role]
        warm = traffic.prompts(-1, role, 1, m["batch"], m["seq"],
                               cfgs[role].vocab_size, dev)[0]
        services[role] = BenchService(role, cfgs[role], params[role], m,
                                      spans, warm, in_high)
    classes = tuple(QoSClass(mix[r]["qos"], priority=mix[r]["priority"],
                             max_batch=1) for r in ROLES)
    system = ServingSystem(Mode.FIKIT, measure_runs=mix["measure_runs"],
                           admission={"classes": classes,
                                      "max_inflight": mix["max_inflight"]})
    return mix, cfgs, refs, params, spans, services, system


def _bound_records(system: ServingSystem) -> None:
    """The port's engine appends every finished kernel, with its request
    and so its input tensor, to a list that only grows: over a window
    that would hold tens of GB of activations on the card. The benchmark
    keeps the last record only."""
    system.engine._records = collections.deque(maxlen=1)


def submit(system, svc: BenchService, qos: str, state, arrival: float):
    """Queue the request's prompt, then offer it; a refused request takes
    its prompt back (dispatch pops prompts in submit order)."""
    svc.svc.pending.append(state)
    t = system.admission.submit(svc, qos, arrival=arrival)
    if t.outcome == REJECTED:
        svc.svc.pending.pop()
    return t


def low_sampler(served: Served, sent: Dict[int, float], k: int):
    """(keeps, bounds): which low requests the head keeps for the outputs
    check. Of those sent inside ``bounds`` (empty until the window opens,
    then [from, until] in perf_counter seconds), the first ``k`` back,
    and then, until ``k`` of the kept ran a layer in a high request's
    gaps, those that did: at most 2k."""
    bounds: List[float] = []

    def keeps(rid: int) -> bool:
        t = sent.get(rid)
        if not bounds or t is None or not bounds[0] <= t <= bounds[1]:
            return False
        n = len(served.kept)
        if n < k:
            return True
        filled = sum(1 for r in served.kept if served.fills[r])
        return served.fills[rid] > 0 and filled < k and n < 2 * k
    return keeps, bounds


def drive(run: Run, system, services, mix, hi_times, hi_prompts,
          lo_prompts, tracer: Optional[Tracer] = None, log=print,
          low_from: Optional[float] = None):
    """The measured window: open-loop high sends at their due times, the
    low backlog kept ``outstanding`` deep, from ``LEAD_S`` before the
    window to its close; then wait for every request sent. A tracer runs
    from before the backlog starts until every request is back. With
    ``low_from`` (a share of the window), the low requests sent inside
    the window after it are kept for the outputs check (``low_sampler``).
    """
    hi, lo = services["high"], services["low"]
    qh, ql = mix["high"]["qos"], mix["low"]["qos"]
    depth = mix["low"]["arrivals"]["outstanding"]
    stop_at = [time.perf_counter() + 3600.0]
    errors: list = []
    lo_sent: Dict[int, float] = {}
    bounds: List[float] = []
    if low_from is not None:
        lo.svc.keeps, bounds = low_sampler(lo.svc, lo_sent,
                                           mix["sample"]["low"])

    def guarded(fn):
        def body():
            try:
                fn()
            except BaseException as e:      # re-raised after the join
                errors.append(e)
                stop_at[0] = -math.inf
        return body

    def low_feeder():
        outstanding: collections.deque = collections.deque()
        j = 0
        while time.perf_counter() < stop_at[0]:
            while len(outstanding) < depth:
                now = time.perf_counter()
                r = Request(j, now)
                lo_sent[j] = now
                r.ticket = submit(system, lo, ql,
                                  (lo_prompts[j % len(lo_prompts)], j), now)
                run.low.append(r)
                outstanding.append(r.ticket)
                j += 1
            outstanding[0].result(timeout=max(0.0, stop_at[0]
                                              - time.perf_counter()))
            while outstanding and outstanding[0].done:
                outstanding.popleft()

    def high_sender():
        lag = 0.0
        for i, a in enumerate(hi_times):
            due = run.t0 + a
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            lag = max(lag, time.perf_counter() - due)
            r = Request(i, due)
            r.ticket = submit(system, hi, qh, (hi_prompts[i], i), due)
            run.high.append(r)
        run.gen_lag_s = lag

    for s in services.values():
        s.svc.onboarding = False
    if tracer is not None:
        tracer.start()
    feeder = threading.Thread(target=guarded(low_feeder),
                              name="servebench-low")
    feeder.start()
    time.sleep(LEAD_S)
    run.t0 = time.perf_counter()
    stop_at[0] = run.t1
    if low_from is not None:
        bounds[:] = [run.t0 + low_from * run.seconds, run.t1]
    fills0 = system.engine.fill_count
    sender = threading.Thread(target=guarded(high_sender),
                              name="servebench-high")
    sender.start()
    sender.join()
    feeder.join()
    if errors:
        raise errors[0]
    rest = run.t1 - time.perf_counter()
    if rest > 0:
        time.sleep(rest)
    run.fills = system.engine.fill_count - fills0
    for r in run.high + run.low:
        r.ticket.result(timeout=max(0.0, run.t1 + LATE_S
                                    - time.perf_counter()))
    if tracer is None:
        return None
    t = time.perf_counter()
    trace = tracer.stop(run.t0, run.t1)
    log(f"trace: {len(trace.ops)} device operations read in "
        f"{time.perf_counter() - t:.1f} s")
    return trace


def outputs_check(run: Run, refs, params, kept: Dict[str, dict],
                  prompts: Dict[str, Callable],
                  limits: dict) -> Dict[str, dict]:
    """Each sampled request of each service through the reference, its
    widest logit gap beside the cell's limit."""
    arith = Arith()
    out = {}
    for role in ROLES:
        gap = 0.0
        def w(name, p=params[role]):
            return p[name].float()
        for rid, prog in sorted(kept[role].items()):
            with torch.no_grad():
                ref = refs[role].logits(w, prompts[role](rid), run.cfg(role),
                                        arith)
            gap = max(gap, logit_gap(prog, ref))
            del ref
        name = f"{role}_logit_gap"
        out[name] = {"value": gap, "limit": limits[name],
                     "requests": len(kept[role])}
    out["low_logit_gap"]["fill_layers"] = sum(run.low_fills.values())
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             root: Path = HERE, cfg_override=None, mix_override=None,
             log=print) -> dict:
    """Set up, measure, check; returns the result line's object (without
    ``device`` fields the caller adds)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(cell_name, root)
    listed = benchmark_entries(cell, root)
    mix, cfgs, refs, params, spans, services, system = build(
        cell, seed, device, cfg_override, mix_override)
    dev = torch.device(device)
    hi_times = traffic.open_loop(mix["high"]["arrivals"], seconds, seed)
    mh, ml = mix["high"], mix["low"]
    hi_prompts = traffic.prompts(seed, "high", len(hi_times), mh["batch"],
                                 mh["seq"], cfgs["high"].vocab_size, dev)
    lo_prompts = traffic.prompts(seed, "low", traffic.LOW_PROMPTS, ml["batch"],
                                 ml["seq"], cfgs["low"].vocab_size, dev)
    sample = traffic.sampled(mix, seed, len(hi_times))
    services["high"].svc.keep.update(sample["high"])
    run = Run(cell, cfgs, seconds)
    tracer = Tracer() if trace else None
    system.start()
    try:
        _bound_records(system)
        for role in ROLES:
            jcts = system.onboard(services[role])
            prof = run.profiles[role] = system.profiles.get(
                services[role].key)
            log(f"onboarded {role}: JCT {[round(1e3 * j, 3) for j in jcts]}"
                f" ms; SK/SG ms " + ", ".join(
                    f"{k.name.rsplit('/', 1)[-1]} {1e3 * v:.3f}/"
                    f"{1e3 * prof.SG.get(k, 0.0):.3f}"
                    for k, v in prof.SK.items()))
        # one request of each through the sharing engine and the plane:
        # its device thread's first launches (library handles) are set-up
        for role in ROLES:
            s = services[role]
            t = submit(system, s, mix[role]["qos"], s.svc._warm,
                       time.perf_counter())
            if t.result(timeout=LATE_S) != COMPLETED:
                raise RuntimeError(f"{role}: warm-up request {t.outcome}")
        del spans[:]
        run.trace = drive(run, system, services, mix, hi_times, hi_prompts,
                          lo_prompts, tracer, log, sample["low_from"])
        run.setup_s = run.t0 - t_start
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
        else:
            peak = 0
    finally:
        system.stop()
    run.spans = [(n, a * 1e-9, b * 1e-9) for n, a, b in spans]
    kept = {r: dict(services[r].svc.kept) for r in ROLES}
    # high: the sampled ids not back; low: how many short of the sample
    missing = {"high": sorted(services["high"].svc.keep
                              - set(kept["high"])),
               "low": max(0, mix["sample"]["low"] - len(kept["low"]))}
    lo_fills = services["low"].svc.fills
    run.low_fills = {rid: lo_fills[rid] for rid in kept["low"]}
    del services, system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prompts = {"high": lambda rid: hi_prompts[rid],
               "low": lambda rid: lo_prompts[rid % traffic.LOW_PROMPTS]}
    t_check = time.perf_counter()
    compared = outputs_check(run, refs, params, kept, prompts,
                             cell.spec["limits"])
    log(f"window: {len(run.high)} high due, {len(run.low)} low sent, "
        f"{run.fills} fills; outputs check "
        f"{time.perf_counter() - t_check:.1f} s")
    attempted = len(run.high) + len([r for r in run.low if r.sent <= run.t1])
    failed = sum(1 for r in run.high + run.low
                 if r.sent <= run.t1 and r.done is None)
    correct = (all(c["value"] <= c["limit"] for c in compared.values())
               and not any(missing.values()))
    metrics = {}
    t_read = time.perf_counter()
    kind = "per_layer" if trace else "end_to_end"
    for m in listed[kind]:
        v = load_metric(m["name"], root)(run)
        if v is None:
            if kind == "end_to_end":
                raise RuntimeError(f"{cell_name}: no reading of {m['name']}")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"metrics read in {time.perf_counter() - t_read:.1f} s")
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "peak": peak, "run": run}
    if missing["high"] or missing["low"]:
        log(f"sampled requests that never came back: high "
            f"{missing['high']}, low {missing['low']} short")
    out["compared"] = compared
    return out
