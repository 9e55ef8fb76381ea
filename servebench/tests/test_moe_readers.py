"""The MoE cell's counts and readers: ``moe_flops`` against hand counts,
and ``moe_gemm_roofline``, ``moe_max_load``, ``mfu.M.moe_fill`` and
``lo_layer_sk_ms.M.moe_fill`` on hand-built runs; none raises where the
program has nothing to read."""
import sys
from types import SimpleNamespace

import pytest

from repro_torch import spans
from servebench import flops, moe_flops
from servebench.catalog import load_metric
from servebench.trace import Trace

MOE = {"family": "moe", "num_layers": 2, "d_model": 8, "num_heads": 2,
       "num_kv_heads": 1, "head_dim": 4, "d_ff": 32, "moe_d_ff": 6,
       "num_experts": 4, "top_k": 2, "vocab_size": 10,
       "sliding_window": None, "name": "moe-x"}


@pytest.mark.parametrize("B, S", [(1, 4), (2, 3)])
def test_moe_forward_by_hand(B, S):
    T, n = B * S, B * S * 2
    proj = 2 * T * (8 * 8 + 2 * 8 * 4 + 8 * 8)
    attn = 2 * 2 * B * 2 * 4 * (S * (S + 1) // 2)
    router = 2 * T * 8 * 4
    experts = 2 * n * 8 * 12 + 2 * n * 6 * 8
    head = 2 * T * 8 * 10
    assert moe_flops.forward_flops(MOE, B, S) == (
        2 * (proj + attn + router + experts) + head)


def test_grouped_product_bounds():
    n = moe_flops.entries(MOE, 2, 3)
    assert n == 12
    # x's 6 token rows read once, not once an entry
    assert moe_flops.gate_up_bytes(MOE, 6, n) == 2 * (2 * 4 * 8 * 6 + 6 * 8
                                                      + 12 * 6)
    assert moe_flops.down_bytes(MOE, n) == 2 * (4 * 6 * 8 + 12 * 6 + 12 * 8)
    # Qwen3-30B-A3B at the cell's B2 S2048: 309 GFLOP, 1.21 GB of weights
    q = dict(MOE, d_model=2048, moe_d_ff=768, num_experts=128, top_k=8)
    N = moe_flops.entries(q, 2, 2048)
    total = moe_flops.gate_up_flops(q, N) + moe_flops.down_flops(q, N)
    assert total == pytest.approx(309.2e9, rel=1e-3)
    assert moe_flops.gate_up_bound_s(q, 2, 2048) == max(
        moe_flops.gate_up_flops(q, N) / flops.PEAK_BF16_FLOPS,
        moe_flops.gate_up_bytes(q, 4096, N) / flops.PEAK_HBM_BYTES)


def _run(ops=(), spans_=(), profiles=None, done=(0, 0)):
    cfgs = {"high": dict(MOE, family="dense", d_ff=16, name="dense-x"),
            "low": MOE}
    shapes = {"high": (1, 4), "low": (2, 3)}
    return SimpleNamespace(
        trace=Trace(0.0, 10.0, list(ops)), spans=list(spans_),
        cfg=lambda role: cfgs[role], shape=lambda role: shapes[role],
        profiles=profiles or {}, seconds=10.0,
        completed_in_window=lambda role: [None] * done[role == "low"])


def test_moe_gemm_roofline_over_the_low_launches():
    ops = [("moe_grouped_gate_up_0d1d", 1.0, 1.5),
           ("moe_grouped_down", 1.6, 1.8),
           ("moe_grouped_down", 5.0, 5.4),      # a high span's: left out
           ("nvjet_gemm", 1.1, 1.2)]
    spans_ = [("low/layer", 0.9, 2.0), ("high/layer", 4.9, 5.5)]
    got = load_metric("moe_gemm_roofline")(_run(ops, spans_))
    bound = (moe_flops.gate_up_bound_s(MOE, 2, 3)
             + moe_flops.down_bound_s(MOE, 2, 3))
    assert got == pytest.approx(100.0 * bound / 0.7)
    assert load_metric("moe_gemm_roofline")(_run([("nvjet", 1, 2)],
                                                 spans_)) is None


def test_mfu_counts_the_moe_by_its_routed_work():
    run = _run(done=(3, 2))
    want = (3 * flops.forward_flops(run.cfg("high"), 1, 4)
            + 2 * moe_flops.forward_flops(MOE, 2, 3))
    assert load_metric("mfu.M.moe_fill")(run) == pytest.approx(
        100.0 * want / (10.0 * flops.PEAK_BF16_FLOPS))
    assert load_metric("mfu.M.moe_fill")(_run()) is None


def test_low_layer_sk():
    from collections import namedtuple
    kid = namedtuple("KernelID", "name")
    prof = SimpleNamespace(SK={kid(name="moe-x/layer"): 0.002,
                               kid(name="moe-x/embed"): 0.5,
                               kid(name="moe-x/layer "): 9.0})
    run = _run(profiles={"low": prof})
    assert load_metric("lo_layer_sk_ms.M.moe_fill")(run) == pytest.approx(2)
    assert load_metric("lo_layer_sk_ms.M.moe_fill")(_run()) is None


def test_moe_max_load_is_the_median_over_layers(monkeypatch):
    rows = [spans.MoECount("moe-x", "layers.0.moe", [4, 2, 1, 1], 0),
            spans.MoECount("moe-x", "layers.1.moe", [2, 2, 2, 2], 0),
            spans.MoECount("moe-x", "layers.2.moe", [8, 0, 0, 0], 0),
            spans.MoECount("other", "layers.0.moe", [9, 0, 0, 0], 0),
            spans.MoECount("moe-x", "layers.3.moe", [0, 0, 0, 0], 0)]
    monkeypatch.setattr(spans, "moe_counts", lambda: rows)
    read = load_metric("moe_max_load")
    assert read(_run()) == pytest.approx(2.0)     # of 2.0, 1.0 and 4.0
    monkeypatch.setattr(spans, "moe_counts", lambda: rows[3:])
    assert read(_run()) is None
    monkeypatch.delattr(spans, "moe_counts")
    assert read(_run()) is None
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(_run()) is None
