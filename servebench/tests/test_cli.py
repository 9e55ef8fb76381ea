"""The command the driver runs: no result without a card, nor without
the program beside the benchmark; on a card, one line of result."""
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

ARGS = ["--workload", "F.fill", "--seed", str(2 ** 31 + 5), "--seconds",
        "4", "--trace", "0"]


def cli(cwd, timeout=600):
    return subprocess.run([sys.executable, "servebench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env={"PATH": "/usr/bin:/bin",
                                                "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    res = cli(ROOT)
    assert res.returncode != 0
    assert "correct" not in res.stdout


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "servebench", tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = cli(tmp_path)
    assert res.returncode != 0
    assert "correct" not in res.stdout


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    res = subprocess.run([sys.executable, "servebench/run.py", *ARGS],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "compared"
