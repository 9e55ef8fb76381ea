"""Full-sequence attention with GQA and causal / sliding-window / chunked
masks, through the flash attention kernel (``repro.models.attention.attend``
in the JAX package). KV caches and MLA come with the decode slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool = True,
           window: Optional[int] = None, chunk: Optional[int] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, Kh, Dh]; qpos: [Sq]; kpos: [Sk].
    Returns [B, Sq, H, Dh].

    The kernel derives positions from indices, so ``qpos``/``kpos`` must
    be the prefill positions 0..S-1 (as every caller in this package
    passes); only their lengths are checked, which needs no device sync.
    On a CUDA device the projections reach the kernel as transposed views
    and its output comes back in [B, Sq, H, Dh] order, so nothing is
    copied on the way. A row with every key masked gives mean(v), the
    kernel's oracle's answer, where the JAX model path gives zeros; causal
    prefill never has such a row.
    """
    if qpos.shape[-1] != q.shape[1] or kpos.shape[-1] != k.shape[1]:
        raise ValueError(f"positions {tuple(qpos.shape)}/{tuple(kpos.shape)}"
                         f" do not match q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)}")
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, chunk=chunk, scale=scale)
    return out.transpose(1, 2)
