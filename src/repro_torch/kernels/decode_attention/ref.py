"""Plain PyTorch version of the decode attention kernel: the JAX package's
``repro.kernels.decode_attention.ref.decode_attention_ref`` in torch,
including its finite mask value: a masked logit is -1e30, so a row whose
every slot is masked gets a uniform softmax, mean(v) over all C slots."""
from __future__ import annotations

import torch

NEG = -1.0e30


def slot_mask(kpos: torch.Tensor, pos: int, window=None, chunk=None):
    """Valid slots [C] of a cache whose slot i holds position kpos[i]
    (-1 = empty), for the query at position ``pos``."""
    valid = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        valid &= pos - kpos < window
    if chunk is not None:
        valid &= torch.div(kpos, chunk, rounding_mode="floor") == pos // chunk
    return valid


def decode_attention_ref(q, k, v, kpos, pos, *, window=None, chunk=None,
                         scale=None):
    """q: [B, H, D]; k/v: [B, Kh, C, D]; kpos: [C] int32; pos: int.
    Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    Kh = k.shape[1]
    G = H // Kh
    scale = scale if scale is not None else D ** -0.5
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    valid = slot_mask(kpos, int(pos), window, chunk)
    logits = torch.where(valid[None, None, :], logits, NEG)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhk,bhkd->bhd", p, v.float()).to(q.dtype)
