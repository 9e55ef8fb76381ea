"""The weights of a run, made by the benchmark from ``--seed``.

Every parameter the configuration's reference names (``param_specs``)
is drawn on the device from one ``torch.Generator`` seeded by the run's
seed and the model's role, in the type the model is served in: all the
normal draws as one buffer, scaled view by view, then the few that are
drawn otherwise. The same tensors are loaded into the program's modules
(``load_into``) and read by the reference, so neither side makes a
weight of its own.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch
from torch import nn

SEED_MOD = 2 ** 63


def generator(seed: int, role: str, device) -> torch.Generator:
    """A generator for ``role`` ("high", "low", "high.tokens", ...) of a
    run's seed; any whole seed, however large."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + zlib.crc32(role.encode())) % SEED_MOD)
    return g


def make(specs: List[Tuple[str, tuple, str, tuple]], g: torch.Generator,
         dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``specs`` of (name, shape, kind, args)."""
    normal = [s for s in specs if s[2] == "normal"]
    total = sum(math.prod(s[1]) for s in normal)
    flat = torch.randn(total, generator=g, dtype=dtype, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, _, (mean, std) in normal:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        at += n
    for name, shape, kind, (lo, hi) in (s for s in specs
                                        if s[2] != "normal"):
        u = torch.rand(shape, generator=g, dtype=torch.float32,
                       device=device)
        if kind == "log_uniform":            # log of U[lo, hi]
            t = torch.log(lo + (hi - lo) * u)
        elif kind == "softplus_inv_log_uniform":
            v = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
            t = v + torch.log(-torch.expm1(-v))
        else:
            raise ValueError(f"{name}: unknown init {kind!r}")
        out[name] = t.to(dtype)
    return out


def load_into(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Put ``weights`` in place of the parameters of ``model`` (built on
    the meta device); the names and shapes must match one for one."""
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if have != want:
        shapes = sorted(n for n in set(have) & set(want)
                        if have[n] != want[n])
        raise ValueError(
            f"parameters differ from the reference's: only the program's "
            f"{sorted(set(have) - set(want))}, only the reference's "
            f"{sorted(set(want) - set(have))}, shapes {shapes}")
    for name, t in weights.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, nn.Parameter(t, requires_grad=False))
