"""A configuration, a mix, a cell and a per-layer metric added as new
files, in a copy of the benchmark, are found by name: no file that was
there is edited (``BENCHMARK.json`` gains entries)."""
import json
import shutil

from conftest import ROOT, reduced
from servebench import harness

SEED = 2 ** 31 + 99


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    root = tmp_path / "servebench"
    shutil.copytree(ROOT / "servebench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    config = json.loads((root / "configs"
                         / "stablelm-1.6b.h2o-danube-3-4b.json").read_text())
    config["low"]["port"]["name"] = "h2o-danube-3-4b-copy"
    (root / "configs" / "new.pair.json").write_text(json.dumps(config))
    mix = json.loads((root / "mixes" / "chat_over_short_docs.json")
                     .read_text())
    mix["low"]["arrivals"]["outstanding"] = 1
    (root / "mixes" / "new_mix.json").write_text(json.dumps(mix))
    (root / "cells" / "N.new.json").write_text(json.dumps(
        {"config": "new.pair", "mix": "new_mix",
         "limits": {"high_logit_gap": 1.0, "low_logit_gap": 1.0}}))
    (root / "metrics" / "lo_requests.new.py").write_text(
        "def read(run):\n    return float(len(run.low))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="new.pair",
                                 file="servebench/configs/new.pair.json"))
    bench["workloads"].append({"name": "N.new", "config": "new.pair",
                               "traffic": "new_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "lo_requests.new", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "traffic generator",
                               "moves": "lo_tokens_per_s",
                               "workloads": ["N.new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cfgs, small = reduced("N.new", root)
    out = harness.run_cell("N.new", SEED, 1.0, True, device="cpu",
                           root=root, cfg_override=cfgs, mix_override=small)
    assert out["correct"]
    assert out["metrics"]["lo_requests.new"]["value"] >= 1
    assert out["run"].cfgs["low"].name.startswith("h2o-danube-3-4b-copy")
    assert {p: p.read_bytes() for p in before} == before


def test_every_metric_is_read_and_moves_what_its_cells_report():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]

    def cells_of(m):
        return m.get("workloads", cells)
    reports = {c: {m["name"] for m in bench["end_to_end"] if c in cells_of(m)}
               for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2, c
        assert any(c in cells_of(m) for m in bench["per_layer"]), c
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "servebench" / "metrics" / f"{m['name']}.py").exists()
        assert callable(harness.load_metric(m["name"]))
    for m in bench["per_layer"]:
        for c in cells_of(m):
            assert m["moves"] in reports[c], (m["name"], c)
