"""Plain PyTorch version of the flash attention kernel: the JAX package's
``repro.kernels.flash_attention.ref.flash_attention_ref`` in torch."""
from __future__ import annotations

import torch

NEG = -1.0e30


def flash_attention_ref(q, k, v, *, causal=True, window=None, chunk=None,
                        scale=None):
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] -> [B, H, Sq, D]."""
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    G = H // Kh
    scale = scale if scale is not None else D ** -0.5
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    if chunk is not None:
        mask &= (qpos // chunk) == (kpos // chunk)
    logits = torch.where(mask, logits, NEG)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
