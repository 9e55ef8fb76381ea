"""The plain references of the M.moe_fill and F.long_docs cells against
the port's served segments at reduced sizes, on the same weights and
prompts the benchmark makes (``test_reference.py``'s check); the fp8
control reads far above the program in both; the MoE reference's routing
from its equations."""
import copy
import dataclasses

import pytest
import torch

from conftest import reduced
from servebench import control, harness, traffic
from servebench.compare import logit_gap
from servebench.reference import qwen3_moe
from servebench.reference.arith import Arith

SEED = 2 ** 31 + 4127
CELLS = ["M.moe_fill", "F.long_docs"]


def small(cell_name: str, rate: float = 6.0):
    """(cfg_override, mix_override) at the port's reduced sizes in float32:
    ``conftest.reduced`` for a dense or SSM low model; for the MoE one the
    same cut (4 experts, top 2: capacity_factor 16 still holds every
    entry) with 32-token prompts."""
    cell = harness.load_cell(cell_name)
    if cell.config["low"]["port"]["family"] != "moe":
        return reduced(cell_name, rate=rate)
    cfgs = {r: dataclasses.asdict(
        harness.port_config(cell.config[r]).reduced()) for r in harness.ROLES}
    mix = copy.deepcopy(cell.mix)
    mix["high"]["seq"], mix["low"]["seq"] = 64, 32
    mix["high"]["arrivals"]["rate_per_s"] = rate
    return cfgs, mix


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("role", ["high", "low"])
def test_reference_matches_the_served_segments(cell_name, role):
    cfgs, mix = small(cell_name)
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


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_reads_far_above_the_program_at_reduced_size(cell_name):
    cfgs, mix = small(cell_name)
    cell = harness.load_cell(cell_name)
    cell.mix = mix
    gaps = control.control_gaps(cell, SEED, 2.0, "cpu", cfgs)
    out = harness.run_cell(cell_name, SEED, 2.0, False, device="cpu",
                           cfg_override=cfgs, mix_override=mix)
    assert out["correct"]
    for role in harness.ROLES:
        prog = out["compared"][f"{role}_logit_gap"]["value"]
        ctl, n = gaps[role]
        assert n == mix["sample"][role]
        assert ctl > 0.1 and ctl > 10 * prog, (role, ctl, prog)


def test_moe_reference_routes_from_the_equations():
    """Softmax over the experts, the top k (the lower expert on a tie),
    renormalised; each token's output the gate-weighted sum of its
    experts, computed one expert at a time."""
    g = torch.Generator().manual_seed(3)
    T, D, E, Fe, k = 6, 8, 5, 4, 2
    h = torch.randn(T, D, generator=g)
    router = torch.randn(D, E, generator=g)
    router[:, 3] = router[:, 1]                # experts 1 and 3 tie
    w1, w3 = torch.randn(E, D, Fe, generator=g), torch.randn(E, D, Fe,
                                                             generator=g)
    w2 = torch.randn(E, Fe, D, generator=g)
    gates, experts = qwen3_moe.route(h, router, k, Arith())
    probs = torch.softmax(h @ router, -1)
    for t in range(T):
        ranked = sorted(range(E), key=lambda e: (-float(probs[t, e]), e))
        assert experts[t].tolist() == ranked[:k]
        want = probs[t, ranked[:k]] / probs[t, ranked[:k]].sum()
        torch.testing.assert_close(gates[t], want)
    out = qwen3_moe.experts_apply(h, gates, experts, w1, w3, w2, Arith())
    for t in range(T):
        want = sum(gates[t, j] * (torch.nn.functional.silu(h[t] @ w1[e])
                                  * (h[t] @ w3[e])) @ w2[e]
                   for j, e in enumerate(experts[t].tolist()))
        torch.testing.assert_close(out[t], want, rtol=1e-5, atol=1e-5)
