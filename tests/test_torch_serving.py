"""End-to-end serving tests of the port on the CPU at reduced scale:
measurement -> sharing lifecycle (``tests/test_serving_e2e.py``'s cases
with the port's dense pair qwen3-4b + stablelm-1.6b), KernelID agreement
with the JAX package, and the rule that the port imports no JAX."""
import statistics as st
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.policy import Mode  # noqa: E402
from repro_torch.launch.serve import main, serve_pair  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.segmentation import SegmentedService  # noqa: E402
from repro_torch.serving import InferenceService, ServingSystem  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module")
def services():
    hi = InferenceService(get_config("qwen3-4b").reduced(), priority=0,
                          batch=1, seq=24, host_gap=0.002, device="cpu")
    lo = InferenceService(get_config("stablelm-1.6b").reduced(), priority=5,
                          batch=2, seq=24, device="cpu")
    return hi, lo


@pytest.mark.parametrize("mode", [Mode.SHARING, Mode.FIKIT])
def test_lifecycle_measure_then_share(services, mode):
    hi, lo = services
    with ServingSystem(mode, measure_runs=3) as sys_:
        jm_hi = sys_.onboard(hi)
        sys_.onboard(lo)
        assert len(jm_hi) == 3 and all(j > 0 for j in jm_hi)
        assert hi.key in sys_.profiles
        prof = sys_.profiles.get(hi.key)
        # segments: embed + 2 layers (same kernel id) + head = 3 unique ids
        assert len(prof.unique_ids) == 3
        assert prof.runs == 3
        res = sys_.invoke_concurrent([
            ("hi", hi, 3, 0.0, 0.005),
            ("lo", lo, 3, 0.0, 0.0),
        ])
        assert len(res["hi"]) == 3 and len(res["lo"]) == 3
        assert all(j > 0 for j in res["hi"] + res["lo"])
        status = sys_.status()
        assert status["mode"] == mode.value and "fills" in status


def test_online_measure_serves_cold_service(services):
    """With online_measure on, the LOW service is never onboarded: it
    starts cold yet serves, and its SK/SG profile is learned live."""
    hi, lo = services
    with ServingSystem(Mode.FIKIT, measure_runs=3,
                       online_measure=True) as sys_:
        sys_.onboard(hi)
        lo.svc.warmup()
        assert lo.key not in sys_.profiles
        res = sys_.invoke_concurrent([
            ("hi", hi, 3, 0.0, 0.005),
            ("lo", lo, 3, 0.0, 0.0),
        ])
        assert len(res["hi"]) == 3 and len(res["lo"]) == 3
        live = sys_.online_stats
        assert live is not None and live["observations"] > 0
    final = sys_.online_stats                # post-stop flush snapshot
    assert final["observations"] >= live["observations"]
    assert final["commits"] >= 1
    prof = sys_.profiles.get(lo.key)
    assert prof is not None and prof.online_observations > 0
    assert all(v > 0 for v in prof.SK.values())
    assert sys_.profiles.cold_start


def test_fikit_sharing_completes_with_deadlines(services):
    """Under FIKIT with a persistent low-priority stream everything
    completes, and low-priority deadlines are tagged and judged."""
    hi, lo = services
    with ServingSystem(Mode.FIKIT, measure_runs=3) as sys_:
        sys_.onboard(hi)
        sys_.onboard(lo)
        res = sys_.invoke_concurrent([
            ("hi", hi, 4, 0.0, 0.01),
            ("lo", lo, 4, 0.0, 0.0, 60.0),
        ])
        assert len(res["hi"]) == 4 and len(res["lo"]) == 4
        assert st.mean(res["hi"]) > 0
        assert sys_.engine.device_busy_time() > 0
        assert sys_.deadlines_tagged == 4 and sys_.deadline_misses == 0


def test_invoke_outside_start_raises(services):
    hi, _ = services
    sys_ = ServingSystem(Mode.FIKIT)
    with pytest.raises(RuntimeError, match="before start"):
        sys_.invoke(hi)


def test_serve_pair_and_cli_on_cpu(capsys):
    out = serve_pair("qwen3-4b", "stablelm-1.6b", mode="fikit", requests=2,
                     measure_runs=2, device="cpu", verbose=False)
    assert out["mode"] == "fikit"
    assert out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0
    assert out["measure_high_ms"] > 0 and out["measure_low_ms"] > 0
    main(["--mode", "sharing", "--requests", "1", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "mode: sharing" in printed and "fills: 0" in printed


def test_cuda_is_the_default_device():
    """No automatic fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        InferenceService(get_config("qwen3-4b").reduced(), priority=0)


def test_segment_kernel_ids_match_jax():
    """A torch segment and a JAX segment of the same avals encode to the
    same KernelID (int32 tokens, float32 activations), so profiles keyed
    by KernelID mean the same thing in both packages."""
    jax = pytest.importorskip("jax")
    from repro import config as jconfig
    from repro.models import api as japi
    from repro.models import segmentation as jseg
    jcfg = jconfig.get_config("qwen3-4b").reduced()
    jsvc = jseg.SegmentedService(
        jcfg, japi.build_params(jcfg, jax.random.key(0)), batch=1, seq=24)
    cfg = get_config("qwen3-4b").reduced()
    svc = SegmentedService(cfg, api.build_params(cfg, device="cpu"),
                           batch=1, seq=24)

    def chain(s, state):
        ids = []
        for seg in s.segments:
            ids.append(seg.kernel_id(state).encode())
            state = seg.fn(state)
        return ids, state

    ids, toks = chain(svc, svc.make_input())
    jids, _ = chain(jsvc, jsvc.make_input())
    assert ids == jids
    assert len(set(ids)) == 3
    assert isinstance(svc.segments[-1].host_work(toks), np.ndarray)


def test_port_imports_no_jax_and_no_reference_package():
    """In a fresh interpreter (this one has loaded jax), importing the
    port's entry points loads no jax and no module of ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serving.engine, "
        "repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
