"""AdamW + global-norm clipping + linear-warmup cosine schedule
(``repro.optim.adamw``) in torch, over a name -> tensor mapping of
parameters (the state dict's names).

Moments are fp32 unless asked otherwise (``moments_dtype``); the update
is applied in fp32 and cast back to each parameter's dtype (the
mixed-precision convention), with the JAX package's arithmetic: the
gradient in fp32 times the clip scale, bias correction with the step as
a float, weight decay on every parameter. The step, the learning rate and
the clip scale are 0-d fp32 tensors on the parameters' device, computed
as the JAX package computes them, so nothing is read back to the host.
The JAX package returns new arrays; this module updates parameters and
moments in place under ``torch.no_grad()`` and returns the same objects,
so callers read it as they read the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                 # 0-d int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Mapping[str, torch.Tensor],
               moments_dtype=torch.float32) -> AdamWState:
    """Zero moments of each parameter's shape in ``moments_dtype`` (bf16
    halves the optimizer state), on its device; step 0."""
    params = dict(params)
    device = next(iter(params.values())).device if params else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=moments_dtype, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu={n: zeros(p) for n, p in params.items()},
                      nu={n: zeros(p) for n, p in params.items()})


def schedule(step: torch.Tensor, base_lr: float, warmup: int = 100,
             total: int = 10_000, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then cosine decay to ``min_frac`` of
    it at ``total``; fp32, as the JAX package computes it."""
    s = step.float()
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their fp32 sums of squares."""
    total = sum(torch.sum(torch.square(g.float())) for g in tree.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, clip_norm: float = 1.0,
                 warmup: int = 100, total_steps: int = 10_000):
    """One step. Returns (params, state, {"grad_norm", "lr"}): the same
    mappings, updated in place, a new state whose step is one more, and
    0-d fp32 tensors."""
    step = state.step + 1
    gn = global_norm(grads)
    scale = torch.clamp_max(clip_norm / (gn + 1e-9), 1.0)
    lr_t = schedule(step, lr, warmup, total_steps)
    sf = step.float()
    c1 = 1 - b1 ** sf
    c2 = 1 - b2 ** sf
    for name, p in params.items():
        # the JAX package's arithmetic, op for op, with temporaries reused
        # in place so that the largest parameter (an embedding of 389 M
        # values at full width) needs about four fp32 copies at a time
        m, v = state.mu[name], state.nu[name]
        g = grads[name].float() * scale
        m32 = m.float() * b1
        m32.add_(g * (1 - b1))                  # b1 m + (1 - b1) g
        v32 = v.float() * b2
        v32.add_(g.square_().mul_(1 - b2))      # b2 v + (1 - b2) g^2
        del g
        m.copy_(m32)
        v.copy_(v32)
        delta = m32.div_(c1)                    # mhat
        delta.div_(v32.div_(c2).sqrt_().add_(eps))
        del v32
        pf = p.float()
        delta.add_(weight_decay * pf)
        p.copy_(pf - delta.mul_(lr_t))          # cast to p's dtype
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gn,
                                                          "lr": lr_t}
