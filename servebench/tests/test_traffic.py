"""The schedule and the inputs a run draws from ``--seed``."""
import pytest
import torch

from servebench import traffic

BIG = 2 ** 31 + 987_654_321
POISSON = {"kind": "poisson", "rate_per_s": 4.0}


def gaps(times):
    return sorted(round(b - a, 12) for a, b in zip(times, times[1:]))


def test_same_seed_same_schedule_and_prompts():
    assert traffic.open_loop(POISSON, 50, BIG) == traffic.open_loop(
        POISSON, 50, BIG)
    a = traffic.prompts(BIG, "high", 3, 2, 16, 1000, "cpu")
    b = traffic.prompts(BIG, "high", 3, 2, 16, 1000, "cpu")
    assert torch.equal(a, b)
    assert a.dtype == torch.int32 and a.shape == (3, 2, 16)
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    assert not torch.equal(a, traffic.prompts(BIG + 1, "high", 3, 2, 16,
                                              1000, "cpu"))
    assert not torch.equal(a, traffic.prompts(BIG, "low", 3, 2, 16, 1000,
                                              "cpu"))


def test_seeds_reorder_the_same_arrivals():
    a = traffic.open_loop(POISSON, 50, 1)
    b = traffic.open_loop(POISSON, 50, BIG)
    assert a != b
    # both take their gaps from one set (each leaves one out, the gap
    # that would follow its last request)
    every = sorted(round(g, 12) for g in traffic.poisson_gaps(4.0, 50))
    for times in (a, b):
        g = gaps(times)
        assert len(g) == len(every) - 1
        assert all(x in every for x in g)
    assert a[0] == b[0] == 0.0
    assert all(0 <= t < 50 for t in a + b)
    assert a == sorted(a)
    # rate x seconds requests, whatever the seed
    assert len(a) == 200


def test_sampled_requests_come_from_the_seed():
    mix = {"sample": {"high": 2, "low": 2}}
    s = traffic.sampled(mix, BIG, 100)
    assert s == traffic.sampled(mix, BIG, 100)
    assert len(s["high"]) == 2 and all(0 <= r < 50 for r in s["high"])
    assert 0 <= s["low_from"] < traffic.LOW_SAMPLE_FROM
    assert len(s["low_prompts"]) == 2
    assert all(0 <= r < traffic.LOW_PROMPTS for r in s["low_prompts"])
    assert any(traffic.sampled(mix, seed, 100) != s for seed in range(5))


def test_only_poisson_arrivals():
    with pytest.raises(ValueError):
        traffic.open_loop({"kind": "diurnal", "rate_per_s": 4.0}, 50, 1)
