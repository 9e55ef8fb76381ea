"""The port's ops plane (jobstore, cancel/pause/resume/drain/recover) and
admission plane (``submit_async``, ``serve_load``) against the JAX
package's, on the CPU.

Engine cases run duck-typed fake services (no model) through each
package's ``ServingSystem``, so one case holds both. Parity cases run
reduced qwen3-4b + mamba2-2.7b at seq 32 through both packages with the
same seed: the open-loop schedule, the job rows a store holds (each
package's ``status`` verb reads the other's store), recovery of a
RUNNING row and the tokens of a paused-and-resumed invocation. CLI cases
parse every verb and run the store-only verbs, and the worker
subprocess, in a fresh interpreter without torch. Cases marked ``cuda``
run the full-width pair on the card and skip elsewhere."""
import importlib
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parent.parent / "src"
PACKAGES = ("repro", "repro_torch")


def _pkg(name):
    """The modules of one package the cases drive; the JAX package's
    engine imports jax."""
    if name == "repro":
        pytest.importorskip("jax")

    def mod(rel):
        return importlib.import_module(f"{name}.{rel}")
    return SimpleNamespace(
        name=name, engine=mod("serving.engine"),
        admission=mod("serving.admission"), jobstore=mod("core.jobstore"),
        client=mod("core.client"), kernel_id=mod("core.kernel_id"),
        task=mod("core.task"), scheduler=mod("core.scheduler"),
        serve=mod("launch.serve"), config=mod("config"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The cases time threads against each other; one intra-op thread per
    process keeps this file from crowding the other test processes'
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=PACKAGES)
def P(request):
    return _pkg(request.param)


def _until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


class _FakeSvc:
    """Duck-typed InferenceService of package ``P``: fake payloads, no
    model."""

    class _Seg:
        def __init__(self, P, name, fn=None):
            self.name = name
            self.fn = fn or (lambda state: state)
            self.host_work = None
            self._kid = P.kernel_id.KernelID(name)

        def kernel_id(self, state):
            return self._kid

    class _Svc:
        def __init__(self, segs):
            self.segments = segs

        def make_input(self):
            return 0

    def __init__(self, P, name="fake", priority=0, n=3, fns=None):
        self.P = P
        self.key = P.task.TaskKey(name)
        self.priority = priority
        fns = fns or [None] * n
        self.svc = self._Svc([self._Seg(P, f"{name}/s{i}", fns[i])
                              for i in range(n)])

    def client(self, engine, identify=True):
        return self.P.client.HookClient(engine, self.key, self.priority,
                                        self.svc.segments,
                                        identify=identify)


def _gate():
    """A segment body that signals when it starts and blocks until
    released: it holds an invocation at a known kernel."""
    entered, release = threading.Event(), threading.Event()

    def fn(state):
        entered.set()
        release.wait(10)
        return state
    return fn, entered, release


def _system(P, **kw):
    return P.engine.ServingSystem(P.scheduler.Mode.FIKIT, **kw)


# ---------------------------------------------------------------------------
# engine cases, each held by both packages
# ---------------------------------------------------------------------------
def test_ops_plane_end_to_end_with_store(P, tmp_path):
    """Invocations under a store reach DONE with full watermarks; cancel,
    pause and resume arrive as control rows through a second connection
    (as the CLI writes them) and the poller applies them."""
    js = P.jobstore
    path = str(tmp_path / "ops.db")
    with js.JobStore(path) as store, js.JobStore(path) as cli:
        with _system(P, jobstore=store) as sys_:
            assert len(sys_.invoke(_FakeSvc(P, n=4), n=2)) == 2
            for j in store.jobs(states=(js.DONE,)):
                assert store.completions(j.job_id) == list(range(4))

            fn, entered, release = _gate()
            svc = _FakeSvc(P, "paused", n=4, fns=[None, fn, None, None])
            out = {}
            th = threading.Thread(
                target=lambda: out.update(j=sys_.invoke(svc, n=1)))
            th.start()
            assert entered.wait(5)
            (job,) = cli.jobs(states=(js.RUNNING,))
            cli.request_control("pause", job.job_id)
            assert _until(lambda: store.job(job.job_id).state == js.PAUSED)
            release.set()
            time.sleep(0.1)
            assert store.job(job.job_id).completed == 2   # held at 2
            cli.request_control("resume", job.job_id)
            th.join(10)
            assert not th.is_alive() and len(out["j"]) == 1
            assert store.job(job.job_id).state == js.DONE

            fn, entered, release = _gate()
            svc = _FakeSvc(P, "cancelled", n=4, fns=[None, fn, None, None])
            th = threading.Thread(
                target=lambda: out.update(c=sys_.invoke(svc, n=1)))
            th.start()
            assert entered.wait(5)
            (job,) = cli.jobs(states=(js.RUNNING,))
            cli.request_control("cancel", job.job_id)
            assert _until(
                lambda: store.job(job.job_id).state == js.CANCELLED)
            release.set()
            th.join(10)
            assert not th.is_alive() and out["c"] == []
            assert sys_.cancelled_invocations == 1
            st = sys_.status()
            assert st["by_state"] == {js.DONE: 3, js.CANCELLED: 1}
            assert st["rejected_controls"] == 0 and st["poller_alive"]


def test_poller_counts_rejected_controls_and_stays_alive(P):
    with P.jobstore.JobStore.memory() as store:
        with _system(P, jobstore=store) as sys_:
            store.request_control("cancel", 99999)      # unknown job
            assert _until(lambda: sys_.rejected_controls == 1, 5)
            st = sys_.status()
            assert st["rejected_controls"] == 1
            assert st["poller_deaths"] == 0 and st["poller_alive"]


def test_poller_death_is_counted_and_logged(P, caplog):
    """A real bug in a verb handler kills the poller, logged and counted.
    The case waits on the poller thread's exit before reading its state
    (the death counter moves before the thread has returned)."""
    with P.jobstore.JobStore.memory() as store:
        with _system(P, jobstore=store) as sys_:
            def broken_cancel(job_id):
                raise OSError("store exploded mid-cancel")
            sys_.cancel = broken_cancel
            poller = sys_._poller
            with caplog.at_level("ERROR",
                                 logger=f"{P.name}.serving.engine"):
                store.request_control("cancel", 1)
                poller.join(timeout=5)
                st = sys_.status()
            assert not poller.is_alive()
            assert st["poller_deaths"] == 1
            assert not st["poller_alive"]
            assert any("poller died" in r.message for r in caplog.records)


def test_wedged_poller_skips_final_checkpoint(P, caplog):
    release, entered = threading.Event(), threading.Event()
    with P.jobstore.JobStore.memory() as store:
        sys_ = _system(P, jobstore=store)
        sys_.start()
        try:
            def slow_cancel(job_id):
                entered.set()
                release.wait(10)
                raise ValueError("late")
            sys_.cancel = slow_cancel
            sys_._poll_join_timeout = 0.05
            snaps = []
            real_snap = store.snapshot_profiles
            store.snapshot_profiles = \
                lambda p: (snaps.append(1), real_snap(p))[1]
            store.request_control("cancel", 1)
            assert entered.wait(5)
            with caplog.at_level("WARNING",
                                 logger=f"{P.name}.serving.engine"):
                sys_.stop()
            assert snaps == []
            assert any("skipping the final profile snapshot" in r.message
                       for r in caplog.records)
        finally:
            release.set()


def test_invoke_async_counts_deadline_misses(P):
    slow = _FakeSvc(P, n=2, fns=[lambda s: (time.sleep(0.02), s)[1], None])
    done = threading.Event()
    got = {}
    with _system(P) as sys_:
        sys_._invoke_async(slow, lambda jct, err: (got.update(jct=jct,
                                                              err=err),
                                                   done.set()),
                           deadline=0.001)
        assert done.wait(5)
        assert got["err"] is None and got["jct"] > 0.02
        assert sys_.deadlines_tagged == 1
        assert sys_.deadline_misses == 1


def test_ops_cancel_resolves_ticket_cancelled(P):
    fn, entered, release = _gate()
    svc = _FakeSvc(P, n=3, fns=[fn, None, None])
    with P.jobstore.JobStore.memory() as store:
        with _system(P, jobstore=store,
                     admission={"max_inflight": 1}) as sys_:
            t = sys_.submit_async(svc, "gold")
            assert entered.wait(5)
            (job,) = store.jobs(states=(P.jobstore.RUNNING,))
            sys_.cancel(job.job_id)
            release.set()
            assert t.result(timeout=5) == P.admission.CANCELLED
            assert sys_.cancelled_invocations == 1
            assert store.job(job.job_id).state == P.jobstore.CANCELLED
            gold = sys_.status()["admission"]["classes"]["gold"]
            assert gold["admitted"] == gold["cancelled"] == 1


def test_failed_payload_resolves_ticket_failed(P):
    """A payload's error reaches its ticket as FAILED, with the error."""
    def boom(state):
        raise RuntimeError("injected payload fault")
    svc = _FakeSvc(P, n=3, fns=[None, boom, None])
    with _system(P, admission=True) as sys_:
        t = sys_.submit_async(svc, "gold")
        assert t.result(timeout=5) == P.admission.FAILED
        assert "injected" in str(t.error)
        assert sys_.status()["admission"]["classes"]["gold"]["failed"] == 1


def test_dispatcher_thread_serves_all_classes(P):
    hi, lo = _FakeSvc(P, "hi", 0), _FakeSvc(P, "lo", 5)
    with _system(P, admission=True) as sys_:
        ts = [sys_.submit_async(hi, "gold") for _ in range(5)]
        ts += [sys_.submit_async(lo, "bronze") for _ in range(5)]
        for t in ts:
            assert t.result(timeout=10) == P.admission.COMPLETED
        st = sys_.status()["admission"]
        assert st["priority_inversions"] == 0
        for name in ("gold", "bronze"):
            s = st["classes"][name]
            assert s["completed"] == 5
            assert s["offered"] == (s["admitted"] + s["rejected"]
                                    + s["shed"] + s["requeued"])


def test_drain(P):
    """The plane's drain finishes in-flight work, then rejects new
    submits with the requeue signal; the ops verb ``drain`` (a control
    row) stops the engine admitting tasks."""
    svc = _FakeSvc(P)
    with P.jobstore.JobStore.memory() as store:
        with _system(P, admission=True, jobstore=store) as sys_:
            ts = [sys_.submit_async(svc, "silver") for _ in range(4)]
            assert sys_.admission.drain(timeout=5)
            late = sys_.submit_async(svc, "silver")
            assert late.outcome == P.admission.REJECTED and late.requeue
            assert all(t.result(timeout=5) == P.admission.COMPLETED
                       for t in ts)
            store.request_control("drain")
            assert _until(lambda: sys_.engine._draining, 5)
            with pytest.raises(RuntimeError, match="draining"):
                sys_.invoke(svc)


def _normalized(trace):
    mapping = {}
    out = []
    for ev in trace:
        ev = tuple(ev)
        if len(ev) > 1 and isinstance(ev[1], int):
            ev = (ev[0], mapping.setdefault(ev[1], len(mapping))) + ev[2:]
        out.append(ev)
    return out


def test_admission_off_trace_identical_to_direct_invoke(P):
    pattern = ["a", "b", "a", "a", "b"]

    def direct():
        svcs = {"a": _FakeSvc(P, "a", 0), "b": _FakeSvc(P, "b", 5)}
        with _system(P) as sys_:
            for name in pattern:
                assert sys_.invoke(svcs[name], n=1)
            return _normalized(list(sys_.engine.policy.trace))

    def through_disabled_plane():
        svcs = {"a": _FakeSvc(P, "a", 0), "b": _FakeSvc(P, "b", 5)}
        qos = {"a": "gold", "b": "bronze"}
        with _system(P, admission={"enabled": False}) as sys_:
            for name in pattern:
                t = sys_.submit_async(svcs[name], qos[name])
                assert t.outcome == P.admission.COMPLETED
            assert not sys_.admission.enabled
            return _normalized(list(sys_.engine.policy.trace))

    a, b = direct(), through_disabled_plane()
    assert a == b
    assert any(ev[0] == "launch" for ev in a)


def test_submit_async_needs_the_plane(P):
    with _system(P) as sys_:
        with pytest.raises(RuntimeError, match="admission plane"):
            sys_.submit_async(_FakeSvc(P), "gold")


# ---------------------------------------------------------------------------
# parity with real reduced models: qwen3-4b + mamba2-2.7b at seq 32
# ---------------------------------------------------------------------------
HI, LO = "qwen3-4b", "mamba2-2.7b"


def _device_kw(P, device="cpu"):
    """The port's entry points take ``device``; the JAX package's do not."""
    return {"device": device} if P.name == "repro_torch" else {}


def _recording_plane(P, monkeypatch):
    """Make every plane the engine builds keep its event log; returns the
    list the planes land in."""
    planes = []
    base = P.engine.AdmissionPlane

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, record_events=True))
            planes.append(self)
    monkeypatch.setattr(P.engine, "AdmissionPlane", Recording)
    return planes


def _check_plane(plane, out):
    """The plane's own invariant in every class after the drain, no
    priority inversion, no failed ticket, and every admitted group's
    members resolved."""
    st = plane.stats()
    assert st["priority_inversions"] == 0 == out["priority_inversions"]
    for name, s in st["classes"].items():
        assert s["offered"] == (s["admitted"] + s["rejected"] + s["shed"]
                                + s["requeued"]), name
        assert s["admitted"] == (s["completed"] + s["failed"]
                                 + s["cancelled"]), name
        assert s["failed"] == 0, name
        assert out[f"{name}_offered"] == s["offered"]
    admits = [e for e in plane.events if e[1] == "admit"]
    assert all(e[4] == 0 for e in admits)     # no higher class was queued
    return st, admits


def test_serve_load_schedule_matches_reference(monkeypatch):
    """Both packages' ``serve_load`` offer the same seeded schedule (total
    and per class), with no priority inversion and the plane's invariant
    in every class."""
    outs = {}
    for name in PACKAGES:
        P = _pkg(name)
        planes = _recording_plane(P, monkeypatch)
        out = P.serve.serve_load(HI, LO, rate=16.0, duration=1.0,
                                 deadline=2.0, diurnal=True, seed=5,
                                 measure_runs=1, verbose=False,
                                 **_device_kw(P))
        (plane,) = planes
        _check_plane(plane, out)
        assert out["gold_completed"] > 0
        outs[name] = out
    keys = ("offered", "gold_offered", "bronze_offered")
    assert [outs["repro"][k] for k in keys] == \
        [outs["repro_torch"][k] for k in keys]
    assert outs["repro"]["offered"] > 5


def test_dispatcher_path_builds_no_autograd_graph():
    """Through ``submit_async`` the dispatcher thread makes the input and
    the device thread runs the segments: no tensor on the way carries an
    autograd graph (the weights need no grad, and each segment runs
    under ``inference_mode``, which is thread-local)."""
    T = _pkg("repro_torch")
    svc = T.engine.InferenceService(T.config.get_config(HI).reduced(),
                                    priority=0, batch=1, seq=32,
                                    device="cpu")
    assert not any(p.requires_grad for p in svc.svc.model.parameters())
    seen = []
    for seg in svc.svc.segments:
        body = seg.fn
        seg.fn = (lambda state, body=body:
                  (seen.append(state), body(state))[1])
    with _system(T, admission=True) as sys_:
        t = sys_.submit_async(svc, "gold")
        assert t.result(timeout=60) == T.admission.COMPLETED
    assert len(seen) == len(svc.svc.segments)
    assert all(isinstance(x, torch.Tensor) and not x.requires_grad
               and x.grad_fn is None for x in seen)


def _rows(store):
    return sorted((j.key.process, j.key.args, j.priority, j.state,
                   j.completed, j.n_kernels) for j in store.jobs())


def _status_text(P, path, capsys):
    P.serve.main(["status", "--jobstore", path])
    return capsys.readouterr().out


def test_jobstore_rows_readable_by_both_packages(tmp_path, capsys):
    """A store written by either package's ``serve_pair(jobstore=)``
    prints the same job table under both packages' ``status`` verb, and
    the two runs leave the same rows (job ids aside)."""
    R, T = _pkg("repro"), _pkg("repro_torch")
    rows = {}
    for P in (R, T):
        path = str(tmp_path / f"{P.name}.db")
        out = P.serve.serve_pair(HI, LO, requests=2, measure_runs=1,
                                 seq=32, jobstore=path, verbose=False,
                                 **_device_kw(P))
        assert out["recovered_jobs"] == 0
        text = _status_text(T, path, capsys)
        assert text == _status_text(R, path, capsys)
        assert [line.split()[3] for line in text.splitlines()[1:]] == \
            [T.jobstore.DONE] * 4
        with T.jobstore.JobStore(path) as store:
            rows[P.name] = _rows(store)
    assert rows["repro"] == rows["repro_torch"]
    assert [r[3] for r in rows["repro"]] == [T.jobstore.DONE] * 4


def test_recover_reruns_a_running_row_to_done(P, tmp_path):
    """A RUNNING row left in the store, as a killed run leaves it, is
    re-run to DONE by ``serve_pair(..., resume=True)``."""
    path = str(tmp_path / "crashed.db")
    key = P.task.TaskKey(f"{HI}-reduced", (2, 32))
    n_kernels = P.config.get_config(HI).reduced().num_layers + 2
    with P.jobstore.JobStore(path) as store:
        job = store.record_submit(None, key, 0, n_kernels=n_kernels,
                                  state=P.jobstore.RUNNING)
        store.record_completion(job, 0)
    out = P.serve.serve_pair(HI, LO, requests=1, measure_runs=1, seq=32,
                             jobstore=path, resume=True, verbose=False,
                             **_device_kw(P))
    assert out["recovered_jobs"] == 1
    with P.jobstore.JobStore(path) as store:
        rec = store.job(job)
        assert rec.state == P.jobstore.DONE
        assert store.completions(job) == list(range(n_kernels))
        assert all(j.state == P.jobstore.DONE for j in store.jobs())


def _capture_tokens(service):
    """Wrap the head segment's sampling so each invocation's tokens are
    kept."""
    head = service.svc.segments[-1]
    sample, toks = head.host_work, []

    def work(logits):
        toks.append(np.asarray(sample(logits)))
        return toks[-1]
    head.host_work = work
    return toks


def pause_resume_tokens(P, path, device="cpu", reduced=True, at=2):
    """One uninterrupted invocation of a qwen3-4b service, then one held
    at segment ``at``, paused and resumed through control rows; returns
    the two invocations' tokens and the watermark while paused."""
    js = P.jobstore
    cfg = P.config.get_config(HI)
    cfg = cfg.reduced() if reduced else cfg
    svc = P.engine.InferenceService(cfg, priority=0, batch=1, seq=32,
                                    **_device_kw(P, device))
    toks = _capture_tokens(svc)
    with js.JobStore(path) as cli, _system(P, jobstore=path) as sys_:
        assert len(sys_.invoke(svc, n=1)) == 1
        seg = svc.svc.segments[at]
        fn, entered, release = _gate()
        body = seg.fn
        seg.fn = lambda state: (fn(state), body(state))[1]
        th = threading.Thread(target=sys_.invoke, args=(svc,))
        th.start()
        try:
            assert entered.wait(10)
            (job,) = cli.jobs(states=(js.RUNNING,))
            cli.request_control("pause", job.job_id)
            assert _until(lambda: cli.job(job.job_id).state == js.PAUSED)
            release.set()
            time.sleep(0.2)
            held = cli.job(job.job_id).completed
            cli.request_control("resume", job.job_id)
            th.join(60)
        finally:
            release.set()
        seg.fn = body
        assert not th.is_alive()
        assert cli.job(job.job_id).state == js.DONE
    return toks, held


def test_paused_and_resumed_invocation_gives_the_same_tokens(P, tmp_path):
    toks, held = pause_resume_tokens(P, str(tmp_path / "pause.db"))
    assert held == 3                     # segments 0..2 ran, 3 buffered
    assert len(toks) == 2 and np.array_equal(toks[0], toks[1])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_every_verb_parses():
    from repro_torch.launch.serve import VERBS, WORKER_VERBS, parse_args
    db = ["--jobstore", "x.db"]
    lines = {
        "submit": ["submit", "--full", "--device", "cpu", "--resume"] + db,
        "load": ["load", "--full", "--rate", "2", "--duration", "8",
                 "--deadline", "0.5", "--diurnal", "--device", "cpu"],
        "status": ["status"] + db,
        "cancel": ["cancel", "3"] + db,
        "pause": ["pause", "3"] + db,
        "resume": ["resume", "3", "--device", "1"] + db,
        "drain": ["drain"] + db,
        "workers": ["workers", "status"] + db,
    }
    assert set(lines) == set(VERBS)
    for verb, argv in lines.items():
        assert parse_args(argv).verb == verb
    a = parse_args(lines["load"])
    assert a.full and a.device == "cpu" and a.rate == 2.0 and a.diurnal
    assert parse_args(lines["resume"]).device == 1
    assert parse_args(["load"]).device == "cuda"
    for w in WORKER_VERBS:
        assert parse_args(["workers", w] + db).wverb == w


def test_flat_form_maps_to_submit(monkeypatch):
    from repro_torch.launch import serve
    calls = []
    monkeypatch.setattr(serve, "serve_pair",
                        lambda *a, **kw: calls.append((a, kw)))
    serve.main(["--full", "--low", "granite-20b", "--jobstore", "j.db"])
    serve.main([])
    (args, kw), (args0, kw0) = calls
    assert args[:2] == ("qwen3-4b", "granite-20b")
    assert not kw["reduced"] and kw["jobstore"] == "j.db"
    assert args0[:3] == ("qwen3-4b", "mamba2-2.7b", "fikit")
    assert kw0["device"] == "cuda" and kw0["reduced"]
    assert kw0["jobstore"] is None and not kw0["resume"]


def _fresh(code, timeout=120):
    return subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(SRC), "PATH": ""},
                          capture_output=True, text=True, timeout=timeout)


def test_store_verbs_run_without_torch(tmp_path):
    """``status``, ``cancel`` and ``workers status`` run in a fresh
    interpreter and leave torch unimported."""
    from repro_torch.core.jobstore import JobStore
    from repro_torch.core.task import TaskKey
    db = str(tmp_path / "s.db")
    with JobStore(db) as store:
        store.record_submit(None, TaskKey("qwen3-4b", (1, 32)), 0,
                            n_kernels=38)
    res = _fresh(
        "import sys\n"
        "from repro_torch.launch.serve import main\n"
        f"main(['status', '--jobstore', {db!r}])\n"
        f"main(['cancel', '1', '--jobstore', {db!r}])\n"
        f"main(['workers', 'status', '--jobstore', {db!r}])\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' "
        "or m.startswith('torch.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "qwen3-4b" in res.stdout and "queued cancel for job 1" in \
        res.stdout
    with JobStore(db) as store:
        assert store.pop_controls() == [("cancel", 1, None)]


def test_worker_module_imports_without_torch():
    res = _fresh(
        "import sys\n"
        "import repro_torch.serving.workers, repro_torch.serving\n"
        "from repro_torch.serving import WorkerSupervisor, QoSClass\n"
        "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr


def test_workers_run_drains_a_store_without_torch(tmp_path):
    """``workers run`` spawns ``python -m repro_torch.serving.workers``
    processes that drain a store of simulated jobs; nothing imports
    torch."""
    from repro_torch.core.jobstore import DONE, JobStore
    from repro_torch.core.kernel_id import KernelID
    from repro_torch.core.task import TaskKey, TaskSpec, TraceKernel
    from repro_torch.serving.workers import enqueue_specs
    specs = [TaskSpec(TaskKey(n), p, [TraceKernel(KernelID(f"{n}/{i}"),
                                                  0.001, 0.0005)
                                      for i in range(3)])
             for n, p in (("hi", 0), ("lo", 5), ("mid", 2))]
    db = str(tmp_path / "fleet.db")
    with JobStore(db) as store:
        enqueue_specs(store, specs, qos="gold")
    res = _fresh(
        "import sys\n"
        "from repro_torch.launch.serve import main\n"
        f"main(['workers', 'run', '-n', '1', '--jobstore', {db!r}])\n"
        "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "w0: jobs=3" in res.stdout
    with JobStore(db) as store:
        assert [j.state for j in store.jobs()] == [DONE] * 3


# ---------------------------------------------------------------------------
# on the card: the full-width pair (skip without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serve_load_full_width_on_card(cuda, monkeypatch):
    T = _pkg("repro_torch")
    planes = _recording_plane(T, monkeypatch)
    # seed 0 draws 4 gold arrivals in these 4 s
    out = T.serve.serve_load(HI, LO, rate=4.0, duration=4.0, deadline=0.5,
                             diurnal=True, reduced=False, device="cuda",
                             verbose=False)
    (plane,) = planes
    _check_plane(plane, out)
    assert out["gold_completed"] == out["gold_offered"] == 4


@pytest.mark.cuda
def test_pause_resume_tokens_full_width_on_card(cuda, tmp_path):
    toks, held = pause_resume_tokens(_pkg("repro_torch"),
                                     str(tmp_path / "pause.db"),
                                     device="cuda", reduced=False, at=5)
    assert held == 6
    assert len(toks) == 2 and np.array_equal(toks[0], toks[1])
