"""Attention with GQA and causal / sliding-window / chunked masks
(``repro.models.attention``): full-sequence attention through the flash
attention kernel, and the ring-buffer KV cache with one-token decode
attention through the decode attention kernel. MLA comes with the MoE/MLA
slice.

The port updates a cache in place (``cache_write``) where the JAX package
returns a new one; every function still returns the cache, so callers
read the same either way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool = True,
           window: Optional[int] = None, chunk: Optional[int] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, Kh, Dh]; qpos: [Sq]; kpos: [Sk].
    Returns [B, Sq, H, Dh].

    The kernel derives positions from indices, so ``qpos``/``kpos`` must
    be the prefill positions 0..S-1 (as every caller in this package
    passes; decode goes through ``decode_attend``); only their lengths
    are checked, which needs no device sync. On a CUDA device the
    projections reach the kernel as transposed views and its output comes
    back in [B, Sq, H, Dh] order, so nothing is copied on the way. A row
    with every key masked gives mean(v), the kernel's oracle's answer,
    where the JAX model path gives zeros; causal prefill never has such a
    row.
    """
    if qpos.shape[-1] != q.shape[1] or kpos.shape[-1] != k.shape[1]:
        raise ValueError(f"positions {tuple(qpos.shape)}/{tuple(kpos.shape)}"
                         f" do not match q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)}")
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, chunk=chunk, scale=scale)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# KV cache (ring buffer when window/chunk-limited)
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor      # [B, C, Kh, Dh]
    v: torch.Tensor      # [B, C, Kh, Dh]
    pos: torch.Tensor    # [C] int32, position held in each slot (-1 = empty)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_kv_cache(batch: int, capacity: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device="cuda") -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, kv_heads, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((capacity,), -1, dtype=torch.int32, device=device),
    )


def cache_capacity(seq_len: int, window: Optional[int],
                   chunk: Optional[int]) -> int:
    """Ring-buffer capacity needed to decode at positions up to seq_len."""
    if window is not None:
        return min(seq_len, window)
    if chunk is not None:
        return min(seq_len, chunk)
    return seq_len


def cache_write(cache: KVCache, k_new, v_new, pos: int) -> KVCache:
    """Write one token (k_new/v_new: [B, 1, Kh, Dh]) at position ``pos``
    (a host int) into slot pos % C, in place."""
    slot = pos % cache.capacity
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[slot] = pos
    return cache


def cache_prefill(cache: KVCache, k_all, v_all, start: int = 0) -> KVCache:
    """Bulk write S tokens (positions start..start+S-1). S < capacity
    writes their slots; S >= capacity keeps the last C tokens, reordered
    so that slot i holds the position p with p % C == i."""
    S = k_all.shape[1]
    C = cache.capacity
    dev = cache.pos.device
    if S >= C:
        k = k_all[:, S - C:].to(cache.k.dtype)
        v = v_all[:, S - C:].to(cache.v.dtype)
        p = torch.arange(start + S - C, start + S, dtype=torch.int32,
                         device=dev)
        order = torch.argsort(torch.remainder(p, C))
        return KVCache(k[:, order], v[:, order], p[order])
    pos = torch.arange(start, start + S, dtype=torch.int32, device=dev)
    slots = torch.remainder(pos, C).long()
    cache.k[:, slots] = k_all.to(cache.k.dtype)
    cache.v[:, slots] = v_all.to(cache.v.dtype)
    cache.pos[slots] = pos
    return cache


def decode_attend(q, cache: KVCache, pos: int, *, window=None, chunk=None,
                  scale=None):
    """One-token attention against a cache. q: [B, 1, H, Dh]; ``pos`` is
    the token's position as a host int. Returns [B, 1, H, Dh].

    The [B, C, Kh, Dh] cache reaches the kernel as a [B, Kh, C, Dh]
    transposed view, so nothing is copied. Every slot masked gives
    mean(v) (the kernel's oracle) where the JAX model path gives zeros;
    ``decode_step`` never has such a row, since the token's own slot is
    always valid."""
    out = decode_ops.decode_attention(
        q[:, 0], cache.k.transpose(1, 2), cache.v.transpose(1, 2), cache.pos,
        pos, window=window, chunk=chunk, scale=scale)
    return out[:, None]
