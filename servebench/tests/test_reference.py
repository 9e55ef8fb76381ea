"""The plain references against the port's served segments at reduced
sizes, on the same weights and prompts the benchmark makes."""
import pytest
import torch

from conftest import reduced
from servebench import harness, traffic
from servebench.compare import logit_gap
from servebench.reference.arith import Arith

SEED = 2 ** 31 + 17


@pytest.mark.parametrize("cell_name", ["F.fill", "A.long_docs"])
@pytest.mark.parametrize("role", ["high", "low"])
def test_reference_matches_the_served_segments(cell_name, role):
    cfgs, mix = reduced(cell_name)
    cell = harness.load_cell(cell_name)
    _, run_cfgs, refs, params, _, services, _ = harness.build(
        cell, SEED, "cpu", cfgs, mix)
    m = mix[role]
    tokens = traffic.prompts(SEED, role, 1, m["batch"], m["seq"],
                             run_cfgs[role].vocab_size, "cpu")[0]
    served = services[role].svc
    served.keep.add(7)
    state = (tokens, 7)
    for seg in served.segments:
        state = seg.fn(state)
    prog = served.kept[7]
    ref = refs[role].logits(lambda n: params[role][n].float(), tokens,
                            cfgs[role], Arith())
    assert prog.shape == ref.shape == (m["batch"], m["seq"],
                                       cfgs[role]["vocab_size"])
    torch.testing.assert_close(prog, ref, rtol=1e-4, atol=1e-4)
    assert logit_gap(prog, ref) < 1e-4


def test_weights_come_from_the_seed_alone():
    cfgs, mix = reduced("F.fill")
    cell = harness.load_cell("F.fill")
    a = harness.build(cell, SEED, "cpu", cfgs, mix)[3]
    b = harness.build(cell, SEED, "cpu", cfgs, mix)[3]
    c = harness.build(cell, SEED + 1, "cpu", cfgs, mix)[3]
    for role in harness.ROLES:
        assert a[role].keys() == b[role].keys()
        assert all(torch.equal(a[role][n], b[role][n]) for n in a[role])
        assert not torch.equal(a[role]["embed"], c[role]["embed"])
