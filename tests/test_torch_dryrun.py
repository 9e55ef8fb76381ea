"""The port's dry-run against the JAX package's, on the CPU.

The JAX package's ``examples/dryrun_one.py`` compiles one step for the
simulated (16, 16) production mesh. Under jax 0.9 its
``make_production_mesh`` (``jax.make_mesh``: Explicit axes) makes its
sharding constraints raise, so the reference runs here with that one
function swapped for an Auto-axes ``jax.sharding.Mesh`` of the same shape
and names (in a subprocess: the dry-run forces 512 host devices before
jax starts); nothing in the JAX package changes. The port's
``examples/torch_dryrun_one.py`` runs the same step eagerly on the meta
device over the fake backend.

- stablelm-1.6b x decode_32k: the per-device argument bytes are the
  reference's to the byte (the same specs, the same shards); the port's
  FLOPs, bytes and collective bytes are non-zero and stand beside the
  reference's trip-count-corrected ones (the FLOPs within 25 %: the
  matrix products are the same, the plain attention's are counted over
  every key slot).
- One step of each kind (train, prefill, decode) runs on meta at full
  width: the train and prefill steps at a cut batch and sequence
  (B16 S512, one sequence per data shard), so the test stays short; the
  records have every key and non-zero costs, and the MoE step's
  collectives include the expert block's all-gathers.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           PYTHONPATH=os.path.join(ROOT, "src"))

_REFERENCE = textwrap.dedent('''
    import sys
    from repro.launch import dryrun as d   # forces the device count first
    import jax, numpy as np

    def auto_mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        n = int(np.prod(shape))
        return jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(shape), axes)

    d.make_production_mesh = auto_mesh
    sys.exit(d.main(sys.argv[1:]))
''')

_KINDS = textwrap.dedent('''
    import json, sys
    from repro_torch.config import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy_host_group
    recs = [
        dryrun.run_one("qwen3-4b", "train_small", verbose=False,
                       shape=InputShape("train_small", 512, 16, "train")),
        dryrun.run_one("llama4-scout-17b-a16e", "prefill_small",
                       verbose=False,
                       shape=InputShape("prefill_small", 512, 16,
                                        "prefill")),
        dryrun.run_one("recurrentgemma-9b", "long_500k", verbose=False),
    ]
    destroy_host_group()
    json.dump(recs, open(sys.argv[1], "w"))
''')


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    ref_out, port_out, kinds_out = (str(d / n) for n in
                                    ("ref.json", "port.json", "kinds.json"))
    args = ["--arch", "stablelm-1.6b", "--shape", "decode_32k"]
    procs = [
        subprocess.Popen([sys.executable, "-c", _REFERENCE, *args, "--out",
                          ref_out], env=ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT),
        subprocess.Popen([sys.executable, os.path.join(
            ROOT, "examples", "torch_dryrun_one.py"), *args, "--out",
            port_out], env=ENV,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        subprocess.Popen([sys.executable, "-c", _KINDS, kinds_out], env=ENV,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
    ]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert "[dryrun] OK (1 combos)" in logs[1]
    load = [json.load(open(f)) for f in (ref_out, port_out, kinds_out)]
    return load[0][0], load[1][0], load[2]


def test_argument_bytes_equal_the_reference_s(records):
    ref, port, _ = records
    assert port["mesh"] == ref["mesh"] == "16x16"
    assert port["devices"] == ref["devices"] == 256
    assert port["mem"]["argument_bytes"] == ref["mem"]["argument_bytes"]


def test_costs_are_reported_beside_the_reference_s(records):
    ref, port, _ = records
    assert port["flops"] > 0 and port["bytes_accessed"] > 0
    assert sum(port["collective_bytes"].values()) > 0
    assert ref["flops_corrected"] > 0 and ref["bytes_corrected"] > 0
    assert abs(port["flops"] / ref["flops_corrected"] - 1) < 0.25
    assert port["mem"]["temp_bytes"] is None or \
        port["mem"]["temp_bytes"] >= 0


@pytest.mark.parametrize("i,kind", [(0, "train"), (1, "prefill"),
                                    (2, "decode")])
def test_each_step_kind_runs_on_meta(records, i, kind):
    rec = records[2][i]
    for key in ("arch", "shape", "mesh", "devices", "flops",
                "bytes_accessed", "collective_bytes", "mem"):
        assert key in rec
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["mem"]["argument_bytes"] > 0 and rec["mem"]["output_bytes"] > 0
    assert rec["collective_bytes"].get("all-gather", 0) > 0
    if kind == "prefill":       # llama4: the expert block's FSDP gathers
        assert rec["collective_counts"]["all-gather"] >= 3 * 48


def test_dryrun_skips_what_the_reference_skips():
    from repro.launch import dryrun as jdry
    from repro_torch.launch import dryrun
    assert dryrun.LONG_SKIP == jdry.LONG_SKIP
    assert list(dryrun.combos()) == list(jdry.combos())
