"""Plain PyTorch version of the RG-LRU scan kernel: the JAX package's
``repro.kernels.rglru_scan.ref.rglru_scan_ref`` in torch.

The JAX oracle runs an associative scan; this one walks S in a plain loop
with the carry in fp32, the order the kernel uses. The two agree to fp32
rounding (the scan multiplies the a's in another order). Autograd
differentiates it: the prefixes are stacked, not written into a buffer
step by step, so its backward stays linear in S.
"""
from __future__ import annotations

from typing import Optional

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1. a/b: [B, S, W]; h0: [B, W]
    or None (zeros). Returns every prefix h: [B, S, W] in a's dtype."""
    af, bf = a.float(), b.float()
    h = (torch.zeros_like(af[:, 0]) if h0 is None else h0.float())
    out = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out.append(h.to(a.dtype))
    return torch.stack(out, dim=1)
