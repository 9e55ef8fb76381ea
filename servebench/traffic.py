"""Traffic of a mix: the arrival schedule of its open-loop class and the
prompts of every request, drawn from ``--seed``.

The Poisson generator follows the port's ``serving/loadgen.py``, copied
so that the yardstick does not move with the program. To keep the work
of a run the same from seed to seed, the seed only reorders the
arrivals: a Poisson class gets rate x seconds gaps at the exponential
distribution's quantiles (i + 1/2) / n, shuffled by the seed. Every seed
sends as many requests, with the same set of gaps, in another order. The
first request is due at the window's start.
"""
from __future__ import annotations

import math
import random
from typing import List

import torch

from servebench.weights import generator

#: prompts of the low backlog, reused in turn (request j sends prompt
#: j % LOW_PROMPTS)
LOW_PROMPTS = 32
#: the low requests checked are sent after a time drawn from the seed in
#: the first LOW_SAMPLE_FROM of the window
LOW_SAMPLE_FROM = 0.5


def poisson_gaps(rate: float, seconds: float) -> List[float]:
    """rate x seconds exponential gaps, one at each quantile (i + 1/2) / n
    of the distribution: a Poisson process's gaps, with none of a draw's
    luck in their number or their sum."""
    n = max(1, round(rate * seconds))
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


def open_loop(arrivals: dict, seconds: float, seed: int) -> List[float]:
    """Due times (seconds after the window's start) of an open-loop class,
    ``{"kind": "poisson", "rate_per_s": r}``."""
    if arrivals["kind"] != "poisson":
        raise ValueError(f"unknown open-loop arrivals {arrivals['kind']!r}")
    gaps = poisson_gaps(arrivals["rate_per_s"], seconds)
    random.Random(seed).shuffle(gaps)
    times, t = [0.0], 0.0
    for g in gaps[:-1]:
        t += g
        times.append(t)
    if t >= seconds:
        raise ValueError(f"{len(times)} arrivals overrun {seconds} s")
    return times


def prompts(seed: int, role: str, count: int, batch: int, seq: int,
            vocab: int, device) -> torch.Tensor:
    """int32 tokens [count, batch, seq], uniform over the vocabulary."""
    g = generator(seed, role + ".tokens", device)
    return torch.randint(0, vocab, (count, batch, seq), generator=g,
                         dtype=torch.int32, device=device)


def sample(seed: int, role: str, population: int, k: int) -> List[int]:
    """``k`` request ids of ``range(population)`` for the outputs check."""
    rng = random.Random(f"{seed}/{role}/sample")
    return sorted(rng.sample(range(population), min(k, population)))


def sampled(mix: dict, seed: int, n_high: int) -> dict:
    """What a run's outputs check draws from the seed. ``high``: the ids
    of ``mix["sample"]["high"]`` requests among the first half of the
    ``n_high`` due (all of them come back well inside the window).
    ``low_from``: the share of the window after which the low requests
    sent are checked (the harness keeps the first ``mix["sample"]["low"]``
    of them, and as many again of those that ran a layer while a high
    request was in flight). ``low_prompts``: ``mix["sample"]["low"]`` of
    the backlog's prompts, which the control reads."""
    k = mix["sample"]
    return {"high": sample(seed, "high", max(1, n_high // 2), k["high"]),
            "low_from": random.Random(f"{seed}/low/from").uniform(
                0.0, LOW_SAMPLE_FROM),
            "low_prompts": sample(seed, "low", LOW_PROMPTS, k["low"])}
