"""Shared set-up of the benchmark's CPU tests: the repository and its
``src`` on the path, and the cells cut to a size the CPU holds."""
import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: prompt lengths at the reduced size (mamba2's reduced chunk is 32)
SEQ = {"high": 64, "low": {"dense": 32, "ssm": 64}}


def reduced(cell_name: str, root=None, rate: float = 6.0):
    """(cfg_override, mix_override) running ``cell_name`` at the port's
    reduced sizes in float32, with short prompts and a quick window."""
    from servebench import harness
    cell = harness.load_cell(cell_name, root or harness.HERE)
    cfgs = {r: dataclasses.asdict(
        harness.port_config(cell.config[r]).reduced()) for r in harness.ROLES}
    mix = copy.deepcopy(cell.mix)
    mix["high"]["seq"] = SEQ["high"]
    mix["low"]["seq"] = SEQ["low"][cfgs["low"]["family"]]
    mix["high"]["arrivals"]["rate_per_s"] = rate
    return cfgs, mix


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
