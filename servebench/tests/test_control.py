"""The control of the outputs check (the reference in float8 put in the
program's place) reads far above the program: on the card at each cell's
own size it fails the cell's limits; on the CPU, at the reduced size, it
reads many times the sound program's gap."""

import pytest

from servebench import control, harness

SEED = 2 ** 31 + 321
CELLS = ["F.fill", "A.long_docs"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_reads_far_above_the_program_at_reduced_size(cell_name):
    from conftest import reduced
    cfgs, mix = reduced(cell_name)
    cell = harness.load_cell(cell_name)
    cell.mix = mix
    gaps = control.control_gaps(cell, SEED, 2.0, "cpu", cfgs)
    out = harness.run_cell(cell_name, SEED, 2.0, False, device="cpu",
                           cfg_override=cfgs, mix_override=mix)
    for role in harness.ROLES:
        prog = out["compared"][f"{role}_logit_gap"]["value"]
        ctl, n = gaps[role]
        assert n == mix["sample"][role]
        assert ctl > 0.1 and ctl > 10 * prog, (role, ctl, prog)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_the_cell_at_its_own_size(cell_name, cuda_device):
    cell = harness.load_cell(cell_name)
    gaps = control.control_gaps(cell, SEED, 50.0, cuda_device)
    limits = cell.spec["limits"]
    assert any(gaps[r][0] > limits[f"{r}_logit_gap"]
               for r in harness.ROLES), (gaps, limits)
