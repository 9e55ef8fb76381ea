"""End-to-end serving tests of the port on the CPU at reduced scale:
measurement -> sharing lifecycle (``tests/test_serving_e2e.py``'s cases
with the port's dense pair qwen3-4b + stablelm-1.6b), pair A (qwen3-4b +
the mamba2-2.7b SSM, the CLI's default pair), pair E (qwen3-4b + the
recurrentgemma-9b hybrid), KernelID agreement with the JAX package, and
the rule that the port imports no JAX."""
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


def test_every_served_kernel_has_its_write_ahead_record(services,
                                                         monkeypatch):
    """With the ops plane's store, each finished invocation's job holds a
    completion record for every one of its kernels, the last one too, even
    when the device thread is slow to go on after resolving a kernel's
    Future (the client may retire the job in that time)."""
    import time
    from concurrent.futures import Future

    from repro_torch.core import executor
    from repro_torch.core import jobstore as js

    class SlowFuture(Future):
        def set_result(self, result):
            super().set_result(result)
            time.sleep(0.02)
    monkeypatch.setattr(executor, "Future", SlowFuture)
    hi, _ = services
    store = js.JobStore.memory()
    with ServingSystem(Mode.FIKIT, measure_runs=2, jobstore=store) as sys_:
        sys_.onboard(hi)
        assert len(sys_.invoke(hi, n=3)) == 3
    jobs = store.jobs()
    assert len(jobs) == 3
    n = len(hi.svc.segments)
    assert all(j.state == js.DONE and j.completed == n for j in jobs)


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
    # the default low service, mamba2-2.7b, needs a seq its reduced SSD
    # chunk (32) divides; the CLI serves seq 48, as the JAX package's does
    main(["--mode", "sharing", "--requests", "1", "--device", "cpu",
          "--low", "stablelm-1.6b"])
    printed = capsys.readouterr().out
    assert "mode: sharing" in printed and "fills: 0" in printed


def test_cli_default_pair_is_pair_a(monkeypatch):
    """With no arguments the CLI serves qwen3-4b over mamba2-2.7b (pair A),
    as ``repro.launch.serve`` does, at full size only with ``--full``."""
    from repro_torch.launch import serve
    calls = []
    monkeypatch.setattr(serve, "serve_pair",
                        lambda *a, **kw: calls.append((a, kw)))
    main([])
    main(["--full"])
    (args, kw), (_, full_kw) = calls
    assert args[:3] == ("qwen3-4b", "mamba2-2.7b", "fikit")
    assert kw["device"] == "cuda" and kw["reduced"]
    assert not full_kw["reduced"]


def test_serve_pair_a_on_cpu():
    """Pair A of the paper's Fig 16 (qwen3-4b high, mamba2-2.7b low)
    serves under FIKIT at reduced scale, at a seq (64) that the reduced
    SSD chunk divides."""
    out = serve_pair("qwen3-4b", "mamba2-2.7b", mode="fikit", requests=2,
                     measure_runs=2, seq=64, device="cpu", verbose=False)
    assert out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0
    assert out["measure_low_ms"] > 0


def test_cuda_is_the_default_device():
    """No automatic fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        InferenceService(get_config("qwen3-4b").reduced(), priority=0)


def _kernel_id_chain(svc, state):
    ids = []
    for seg in svc.segments:
        ids.append(seg.kernel_id(state).encode())
        state = seg.fn(state)
    return ids, state


def _check_kernel_ids_match_jax(arch, unique):
    jax = pytest.importorskip("jax")
    from repro import config as jconfig
    from repro.models import api as japi
    from repro.models import segmentation as jseg
    jcfg = jconfig.get_config(arch).reduced()
    jsvc = jseg.SegmentedService(
        jcfg, japi.build_params(jcfg, jax.random.key(0)), batch=1, seq=24)
    cfg = get_config(arch).reduced()
    svc = SegmentedService(cfg, api.build_params(cfg, device="cpu"),
                           batch=1, seq=24)
    ids, toks = _kernel_id_chain(svc, svc.make_input())
    jids, _ = _kernel_id_chain(jsvc, jsvc.make_input())
    assert ids == jids
    assert [seg.name for seg in svc.segments] == \
        [seg.name for seg in jsvc.segments]
    assert len(set(ids)) == unique
    assert isinstance(svc.segments[-1].host_work(toks), np.ndarray)


def test_segment_kernel_ids_match_jax():
    """A torch segment and a JAX segment of the same avals encode to the
    same KernelID (int32 tokens, float32 activations), so profiles keyed
    by KernelID mean the same thing in both packages."""
    _check_kernel_ids_match_jax("qwen3-4b", unique=3)


def test_hybrid_segment_kernel_ids_match_jax():
    """The hybrid's segments (embed, rec, attn, head) get the JAX
    package's KernelIDs too."""
    _check_kernel_ids_match_jax("recurrentgemma-9b", unique=4)


def test_ssm_segment_kernel_ids_match_jax():
    """mamba2's segments (embed, one layer KernelID for every layer, head)
    get the JAX package's KernelIDs: fp32 [B, S, D] activations."""
    _check_kernel_ids_match_jax("mamba2-2.7b", unique=3)


def test_ssm_segment_chain_equals_forward():
    """embed -> SSD layer x L -> head through the service's segments gives
    mamba2's logits."""
    cfg = get_config("mamba2-2.7b").reduced()
    model = api.build_params(cfg, seed=3, device="cpu")
    svc = SegmentedService(cfg, model, batch=2, seq=64)
    names = [seg.name.split("/")[1] for seg in svc.segments]
    assert names == ["embed"] + ["layer"] * cfg.num_layers + ["head"]
    tokens = svc.make_input()
    state = tokens
    for seg in svc.segments:
        state = seg.fn(state)
    logits, _ = api.forward(model, tokens, cfg)
    torch.testing.assert_close(state, logits, rtol=0, atol=0)


def test_hybrid_segment_chain_equals_forward():
    """embed -> rec/attn blocks -> head through the service's segments
    gives the hybrid's logits."""
    cfg = get_config("recurrentgemma-9b").reduced()
    model = api.build_params(cfg, seed=3, device="cpu")
    svc = SegmentedService(cfg, model, batch=2, seq=24)
    names = [seg.name.split("/")[1] for seg in svc.segments]
    assert names == ["embed", "rec", "attn", "head"]
    tokens = svc.make_input()
    state = tokens
    for seg in svc.segments:
        state = seg.fn(state)
    logits, _ = api.forward(model, tokens, cfg)
    torch.testing.assert_close(state, logits, rtol=0, atol=0)


def test_serve_pair_e_on_cpu():
    """Pair E of the paper's Fig 16 (qwen3-4b high, recurrentgemma-9b
    low) serves under FIKIT at reduced scale."""
    out = serve_pair("qwen3-4b", "recurrentgemma-9b", mode="fikit",
                     requests=2, measure_runs=2, device="cpu", verbose=False)
    assert out["high_jct_ms"] > 0 and out["low_jct_ms"] > 0
    assert out["measure_low_ms"] > 0


def test_port_imports_no_jax_and_no_reference_package():
    """In a fresh interpreter (this one has loaded jax), importing the
    port's entry points loads no jax and no module of ``repro``, nor
    ``msgpack`` (the checkpoint module imports it when it writes or reads
    a file: the card's machine does not have it)."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serving.engine, "
        "repro_torch.launch.serve, repro_torch.bridge, "
        "repro_torch.models.rglru, repro_torch.models.mamba2, "
        "repro_torch.models.moe, "
        "repro_torch.configs.llama4_scout_17b_a16e, "
        "repro_torch.configs.deepseek_v2_236b, "
        "repro_torch.configs.mamba2_2_7b, repro_torch.configs.granite_20b, "
        "repro_torch.models.encdec, repro_torch.models.vlm, "
        "repro_torch.configs.seamless_m4t_medium, "
        "repro_torch.configs.llava_next_mistral_7b, "
        "repro_torch.configs.h2o_danube_3_4b, "
        "repro_torch.kernels.rglru_scan.ops, "
        "repro_torch.kernels.decode_attention.ops, "
        "repro_torch.kernels.flash_attention.ops, "
        "repro_torch.core.faults, repro_torch.core.profile_store, "
        "repro_torch.core.jobstore, repro_torch.core.scheduler, "
        "repro_torch.serving.loadgen, repro_torch.serving.admission, "
        "repro_torch.serving.workers, repro_torch.launch.train, "
        "repro_torch.launch.steps, repro_torch.optim.adamw, "
        "repro_torch.checkpoint.ckpt, repro_torch.data.pipeline, "
        "repro_torch.sim.workload, repro_torch.sim.fleet, "
        "repro_torch.sim.analytics, repro_torch.sharding.context, "
        "repro_torch.sharding.specs, repro_torch.launch.mesh, "
        "repro_torch.launch.cost, repro_torch.launch.dryrun, "
        "repro_torch.kernels._sharded\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'msgpack')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
