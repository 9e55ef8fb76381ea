"""Which low requests the outputs check keeps: only those sent inside the
window after the seed's time, the first ones back and then those that ran
a layer in a high request's gaps. At reduced size on the CPU, with a high
host gap long enough for a low layer to fill it, a run keeps such
requests, and a low layer that goes wrong only when it fills a gap comes
out not correct."""
import collections


from conftest import reduced
from repro_torch.models import transformer as tfm
from servebench import harness, traffic

SEED = 2 ** 31 + 777
#: a high host gap (ms) that a reduced low layer fits on the CPU
GAP_MS = 30.0


class FakeServed:
    def __init__(self):
        self.kept = {}
        self.fills = collections.Counter()


def test_the_sampler_keeps_window_requests_and_prefers_fills():
    served = FakeServed()
    sent = {rid: float(rid) for rid in range(12)}
    keeps, bounds = harness.low_sampler(served, sent, 2)
    assert not keeps(5)                      # the window is not open yet
    bounds[:] = [3.0, 9.0]
    served.fills.update({7: 2, 9: 1, 10: 4})

    def back(rid):
        if keeps(rid):
            served.kept[rid] = object()
    for rid in range(12):
        back(rid)
    # 3 and 4 come back first; then 7 and 9 ran layers in high gaps; 10
    # was sent after the window
    assert sorted(served.kept) == [3, 4, 7, 9]


def test_the_sampler_stops_at_k_filled():
    served = FakeServed()
    sent = {rid: float(rid) for rid in range(8)}
    keeps, bounds = harness.low_sampler(served, sent, 2)
    bounds[:] = [0.0, 8.0]
    served.fills.update({0: 1, 2: 1, 3: 1})
    for rid in range(8):
        if keeps(rid):
            served.kept[rid] = object()
    assert sorted(served.kept) == [0, 1, 2]


def fill_cell():
    cfgs, mix = reduced("F.fill")
    mix["high"]["host_gap_ms"] = GAP_MS
    return cfgs, mix


def test_a_run_checks_low_requests_sent_inside_the_window():
    cfgs, mix = fill_cell()
    out = harness.run_cell("F.fill", SEED, 2.0, False, device="cpu",
                           cfg_override=cfgs, mix_override=mix)
    run = out["run"]
    low_from = traffic.sampled(mix, SEED, len(run.high))["low_from"]
    sent = {r.rid: r.sent for r in run.low}
    assert 2 <= len(run.low_fills) <= 4
    for rid in run.low_fills:
        assert run.t0 + low_from * run.seconds <= sent[rid] <= run.t1
    low = out["compared"]["low_logit_gap"]
    assert low["requests"] == len(run.low_fills)
    assert low["fill_layers"] == sum(run.low_fills.values()) > 0
    assert out["correct"]


def test_a_low_layer_wrong_only_in_high_gaps_is_caught(monkeypatch):
    """The low service's layer returns its state unchanged when it runs
    while a high request is in flight, and only then."""
    cfgs, mix = fill_cell()
    low_name = cfgs["low"]["name"]
    held = {}
    build = harness.build

    def keep_services(*a, **k):
        out = build(*a, **k)
        held["in_high"] = out[5]["low"].svc.in_high
        return out
    layer_apply = tfm.layer_apply

    def layer(lp, x, positions, cfg, *a, **k):
        if cfg.name == low_name and held["in_high"][0] > 0:
            return x
        return layer_apply(lp, x, positions, cfg, *a, **k)
    monkeypatch.setattr(harness, "build", keep_services)
    monkeypatch.setattr(tfm, "layer_apply", layer)
    out = harness.run_cell("F.fill", SEED, 2.0, False, device="cpu",
                           cfg_override=cfgs, mix_override=mix)
    low = out["compared"]["low_logit_gap"]
    assert low["fill_layers"] > 0
    assert low["value"] > low["limit"] and not out["correct"], low
