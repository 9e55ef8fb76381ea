"""The port's copies of the framework-free modules are the reference: each
equals the JAX package's source with the import prefix ``repro.`` turned
into ``repro_torch.``. ``core/kernel_id.py`` may differ only in
``_aval_fp``, which also names torch dtypes, and ``core/executor.py`` only
in ``WallClockEngine._device_loop``, which commits a kernel's write-ahead
record before its Future resolves."""
import ast
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parent.parent / "src"

VERBATIM = [
    "core/task.py", "core/interference.py", "core/profiler.py",
    "core/queues.py", "core/fikit.py", "core/policy.py",
    "core/placement.py", "core/online.py", "core/executor.py",
    "core/client.py", "config.py", "configs/qwen3_4b.py",
    "configs/stablelm_1_6b.py", "configs/recurrentgemma_9b.py",
    "configs/mamba2_2_7b.py", "configs/granite_20b.py",
    "core/faults.py", "core/profile_store.py", "core/jobstore.py",
    "core/scheduler.py", "serving/loadgen.py", "serving/admission.py",
    "serving/workers.py", "configs/h2o_danube_3_4b.py",
    "configs/seamless_m4t_medium.py", "configs/llava_next_mistral_7b.py",
    "data/pipeline.py", "sim/__init__.py", "sim/analytics.py",
    "sim/fleet.py", "sim/workload.py", "configs/llama4_scout_17b_a16e.py",
    "configs/deepseek_v2_236b.py", "configs/__init__.py",
]

#: the one function of a copied module that the port repairs
REPAIRED = {"core/executor.py": "WallClockEngine._device_loop"}


def _sources(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    return ref.replace("repro.", "repro_torch."), port


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_verbatim(rel):
    want, port = _sources(rel)
    if rel in REPAIRED:
        want, port = (_without(want, REPAIRED[rel]),
                      _without(port, REPAIRED[rel]))
    assert port == want


def _without(source, fn_name):
    """Module source with the top-level function or class ``fn_name`` (or
    the method ``Class.method``) cut out."""
    node = ast.parse(source)
    for name in fn_name.split("."):
        (node,) = [n for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                   and n.name == name]
    lines = source.splitlines(keepends=True)
    return "".join(lines[:node.lineno - 1] + lines[node.end_lineno:])


def test_kernel_id_differs_only_in_aval_fp():
    want, port = _sources("core/kernel_id.py")
    assert port != want
    assert _without(port, "_aval_fp") == _without(want, "_aval_fp")


def test_aval_fp_names_torch_dtypes_as_numpy_does():
    torch = pytest.importorskip("torch")
    from repro_torch.core.kernel_id import _aval_fp, kernel_id_for
    for td, nd in ((torch.float32, np.float32), (torch.int32, np.int32),
                   (torch.bfloat16, None)):
        t = torch.zeros((2, 3), dtype=td)
        name = str(td).split(".")[1]
        assert _aval_fp(t) == (2, 3, name)
        if nd is not None:
            assert _aval_fp(np.zeros((2, 3), nd)) == (2, 3, name)
    kid = kernel_id_for("svc/layer", inputs=[torch.zeros(1, 4,
                                                         dtype=torch.int32)])
    assert kid.encode() == "svc/layer|()|(1, 4, 'int32')"


def test_serving_system_is_the_reference_s():
    """``serving/engine.py`` differs from the reference only in its module
    docstring, the reference's ``import jax`` and ``InferenceService``
    (torch weights on a ``device``): ``ServingSystem``, with its ops and
    admission planes, is the reference's source."""
    want, port = _sources("serving/engine.py")

    def body(source):
        source = _without(source, "InferenceService")
        source = source.split("from __future__ import annotations\n", 1)[1]
        return source.replace("import jax\n\n", "")
    assert body(port) == body(want)


def test_write_ahead_record_commits_before_the_future_resolves():
    """The port's repair of the copied engine: a client woken by its
    kernel's Future already finds that kernel's write-ahead record, however
    slow the record is (the reference resolves the Future first, so a
    client that retires its job at once can leave the last record with no
    job to land in)."""
    import time

    from repro_torch.core.executor import WallClockEngine
    from repro_torch.core.policy import Mode
    from repro_torch.core.task import KernelID, KernelRequest, TaskKey

    recorded = []

    def slow_record(req, start, end):
        time.sleep(0.05)
        recorded.append(req.seq_index)

    with WallClockEngine(Mode.SHARING, on_kernel_complete=slow_record) as eng:
        eng.task_begin(1, TaskKey("t"), 0)
        for i in range(3):
            req = KernelRequest(task_key=TaskKey("t"),
                                kernel_id=KernelID("t/k"), priority=0,
                                task_instance=1, seq_index=i,
                                payload=lambda i=i: i)
            assert eng.submit(req).result(timeout=10)[0] == i
            assert recorded == list(range(i + 1))
        eng.task_end(1)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_failed_write_ahead_record_fails_the_kernel_s_future():
    """A store that cannot record is not silently dropped: the client's
    Future raises the store's error."""
    from repro_torch.core.executor import WallClockEngine
    from repro_torch.core.policy import Mode
    from repro_torch.core.task import KernelID, KernelRequest, TaskKey

    def broken_store(req, start, end):
        raise OSError("disk full")

    with WallClockEngine(Mode.SHARING, on_kernel_complete=broken_store) as eng:
        eng.task_begin(1, TaskKey("t"), 0)
        req = KernelRequest(task_key=TaskKey("t"), kernel_id=KernelID("t/k"),
                            priority=0, task_instance=1, seq_index=0,
                            payload=lambda: 0)
        with pytest.raises(OSError, match="disk full"):
            eng.submit(req).result(timeout=10)


def test_quickstart_example_is_the_reference_s():
    """``examples/torch_quickstart.py`` is the JAX package's pure-core
    ``examples/quickstart.py`` with the prefix turned (and its own name in
    the run line), and runs: the simulator prints every mode's row."""
    import subprocess
    import sys
    ex = SRC.parent / "examples"
    want = (ex / "quickstart.py").read_text().replace(
        "repro.", "repro_torch.").replace("examples/quickstart.py",
                                          "examples/torch_quickstart.py")
    assert (ex / "torch_quickstart.py").read_text() == want
    out = subprocess.run(
        [sys.executable, str(ex / "torch_quickstart.py")], check=True,
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}).stdout
    ref = subprocess.run(
        [sys.executable, str(ex / "quickstart.py")], check=True,
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"}).stdout
    assert out == ref and "FIKIT" in out
