"""Mamba2 (SSD) pieces of ``repro.models.mamba2`` that other families use.

Only the depthwise causal convolution is here so far: the recurrentgemma
hybrid's rec blocks call it (``repro.models.rglru``). The rest of mamba2
(the chunked SSD scan, its layers, prefill and decode) comes with the
mamba2 slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 buf: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B,S,F], w: [K,F]. buf: [B,K-1,F] history.

    Returns (y [B,S,F], new_buf [B,K-1,F]). y_t = sum_k w[k] * xp[t + k]
    over the history-padded input xp, summed in x's dtype in the order
    k = 0..K-1, as the JAX package does.
    """
    K = w.shape[0]
    if buf is None:
        buf = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    xp = torch.cat([buf.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for k in range(K):
        y = y + xp[:, k:k + S] * w[k]
    new_buf = xp[:, -(K - 1):] if K > 1 else buf
    return y, new_buf
