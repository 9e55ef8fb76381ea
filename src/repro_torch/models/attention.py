"""Attention with GQA and causal / sliding-window / chunked masks
(``repro.models.attention``): full-sequence attention through the flash
attention kernel, and the ring-buffer KV cache with one-token decode
attention through the decode attention kernel; and MLA (deepseek-v2),
compressed-KV attention, as torch ops (the JAX package's MLA is jnp too,
and its q/k head, 128 + 64 rope, differs from its v head, 128, so no
flash instance applies).

The port updates a cache in place (``cache_write``) where the JAX package
returns a new one; every function still returns the cache, so callers
read the same either way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels._sharded import local_offset
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import layers
from repro_torch.sharding import context as shctx
from repro_torch.sharding.context import constrain, model_axis_size


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool = True,
           window: Optional[int] = None, chunk: Optional[int] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, Kh, Dh]; qpos: [Sq]; kpos: [Sk].
    Returns [B, Sq, H, Dh].

    The kernel derives positions from indices, so its contract is:
    ``qpos``/``kpos`` are the positions 0..S-1 of a full sequence, or
    they do not enter the mask. Every caller in this package passes one
    of the two: self-attention over ``arange(S)`` (the dense decoder, the
    VLM's patches and tokens, the encoder and the decoder of the
    encoder-decoder), or cross-attention (Sq != Sk), which is non-causal
    with no window or chunk, so that every query sees every key whatever
    the positions. Only the lengths are checked, and a mask that would
    read positions with Sq != Sk raises; neither needs a device sync.
    Decode goes through ``decode_attend``. On a CUDA device the
    projections reach the kernel as transposed views and its output comes
    back in [B, Sq, H, Dh] order, so nothing is copied on the way. A row
    with every key masked gives mean(v), the kernel's oracle's answer,
    where the JAX model path gives zeros; causal self-attention and
    cross-attention never have such a row.
    """
    if qpos.shape[-1] != q.shape[1] or kpos.shape[-1] != k.shape[1]:
        raise ValueError(f"positions {tuple(qpos.shape)}/{tuple(kpos.shape)}"
                         f" do not match q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)}")
    if q.shape[1] != k.shape[1] and (causal or window is not None
                                     or chunk is not None):
        raise ValueError(f"attend: Sq {q.shape[1]} != Sk {k.shape[1]} takes "
                         f"only cross-attention (causal=False, no window or "
                         f"chunk); got causal={causal}, window={window}, "
                         f"chunk={chunk}")
    # under a mesh: batch and heads sharded, as the JAX package pins its
    # [B, H, Qb, S] logits; kv heads that do not divide stay replicated
    q = constrain(q, "batch", None, "model", None)
    k = constrain(k, "batch", None, "model", None)
    v = constrain(v, "batch", None, "model", None)
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


def kv_spec(kv_heads: int):
    """The KV cache's layout under a mesh (the JAX package's ``_kv_dims``):
    kv heads on ``model`` when they divide it, else the sequence."""
    if kv_heads % model_axis_size() == 0:
        return ("batch", None, "model", None)
    return ("batch", "model", None, None)


def init_kv_cache(batch: int, capacity: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device="cuda") -> KVCache:
    shape = (batch, capacity, kv_heads, head_dim)
    return KVCache(
        k=shctx.zeros(shape, dtype, device, *kv_spec(kv_heads)),
        v=shctx.zeros(shape, dtype, device, *kv_spec(kv_heads)),
        pos=shctx.full((capacity,), -1, torch.int32, device, None),
    )


def cache_capacity(seq_len: int, window: Optional[int],
                   chunk: Optional[int]) -> int:
    """Ring-buffer capacity needed to decode at positions up to seq_len."""
    if window is not None:
        return min(seq_len, window)
    if chunk is not None:
        return min(seq_len, chunk)
    return seq_len


def put(buf, dim: int, index, vals) -> None:
    """``buf[(:,) * dim + (index,)] = vals``, in place. A ``DTensor`` buffer
    is written on its local shard: ``vals`` is placed as the buffer with
    ``dim`` replicated (a python scalar as it is), and each rank writes
    the slots its shard holds (an indexed write through a DTensor whose
    ``dim`` is sharded would land in a gathered copy)."""
    lead = (slice(None),) * dim
    if not isinstance(buf, DTensor):
        buf[lead + (index,)] = vals
        return
    mesh = buf.device_mesh
    drop = isinstance(index, int)     # vals lacks ``dim``: later dims shift
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else
            Shard(p.dim - 1) if drop and isinstance(p, Shard) and p.dim > dim
            else p for p in buf.placements]
    if isinstance(vals, torch.Tensor) and not isinstance(vals, DTensor):
        vals = DTensor.from_local(vals, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    vl = vals.redistribute(mesh, want).to_local() \
        if isinstance(vals, DTensor) else vals       # a python scalar
    off, n = local_offset(buf, dim)
    loc = buf.to_local()
    if isinstance(index, int):
        if off <= index < off + n:
            loc[lead + (index - off,)] = vl
        return
    mine = (index >= off) & (index < off + n)
    loc[lead + (index[mine] - off,)] = vl[lead + (mine,)]


def cache_write(cache: KVCache, k_new, v_new, pos: int) -> KVCache:
    """Write one token (k_new/v_new: [B, 1, Kh, Dh]) at position ``pos``
    (a host int) into slot pos % C, in place."""
    slot = pos % cache.capacity
    put(cache.k, 1, slot, k_new[:, 0].to(cache.k.dtype))
    put(cache.v, 1, slot, v_new[:, 0].to(cache.v.dtype))
    put(cache.pos, 0, slot, pos)
    return cache


def cache_prefill(cache, *new, start: int = 0):
    """Bulk write S tokens (positions start..start+S-1) into a ring cache:
    a ``KVCache`` given (k_all, v_all) or an ``MLACache`` given (c_all,
    kr_all), each [B, S, ...], one tensor for each field before ``pos``.
    S < capacity writes their slots; S >= capacity keeps the last C
    tokens, reordered so that slot i holds the position p with
    p % C == i."""
    fields = cache[:-1]
    S = new[0].shape[1]
    C = cache.capacity
    dev = cache.pos.device
    if S >= C:
        p = torch.arange(start + S - C, start + S, dtype=torch.int32,
                         device=dev)
        order = torch.argsort(torch.remainder(p, C))
        return type(cache)(*(n[:, S - C:].to(f.dtype)[:, order]
                             for f, n in zip(fields, new)), p[order])
    pos = torch.arange(start, start + S, dtype=torch.int32, device=dev)
    slots = torch.remainder(pos, C).long()
    for f, n in zip(fields, new):
        put(f, 1, slots, n.to(f.dtype))
    put(cache.pos, 0, slots, pos)
    return cache


def decode_attend(q, cache: KVCache, pos: int, *, window=None, chunk=None,
                  scale=None):
    """One-token attention against a cache. q: [B, 1, H, Dh]; ``pos`` is
    the token's position as a host int. Returns [B, 1, H, Dh].

    The [B, C, Kh, Dh] cache reaches the kernel as a [B, Kh, C, Dh]
    transposed view, so nothing is copied. Every slot masked gives
    mean(v) (the kernel's oracle) where the JAX model path gives zeros;
    ``decode_step`` never has such a row, since the token's own slot is
    always valid.

    Under a mesh q is pinned head-sharded; a cache whose kv heads do not
    divide the model axis is pinned sequence-sharded, as the JAX package
    pins its logits, and the kernel wrapper gathers it."""
    k, v = cache.k, cache.v
    msize = model_axis_size()
    if msize > 1 and k.shape[2] % msize != 0 and \
            cache.capacity % msize == 0:
        k = constrain(k, "batch", "model", None, None)   # [B,C,Kh,Dh]: C
        v = constrain(v, "batch", "model", None, None)
    q = constrain(q, "batch", None, "model", None)
    out = decode_ops.decode_attention(
        q[:, 0], k.transpose(1, 2), v.transpose(1, 2), cache.pos,
        pos, window=window, chunk=chunk, scale=scale)
    return out[:, None]


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): compressed-KV attention. Cache = (c_kv, k_rope, pos).
# ---------------------------------------------------------------------------
NEG_INF = -2.0e38


def _mask(qpos, kpos, *, causal: bool):
    """qpos: [..., Q], kpos: [..., K] int32 -> bool [..., Q, K]: the JAX
    package's ``_mask`` with no window and no chunk (MLA takes neither).
    kpos < 0 marks an invalid (unwritten) cache slot."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    return m


class MLACache(NamedTuple):
    c: torch.Tensor      # [B, C, r]   compressed latent
    kr: torch.Tensor     # [B, C, Dr]  rope'd shared key part
    pos: torch.Tensor    # [C] int32, position held in each slot (-1 = empty)

    @property
    def capacity(self) -> int:
        return self.c.shape[1]


def init_mla_cache(batch: int, capacity: int, r: int, rope_dim: int,
                   dtype: torch.dtype, device="cuda") -> MLACache:
    return MLACache(
        c=shctx.zeros((batch, capacity, r), dtype, device, "batch", "model",
                      None),
        kr=shctx.zeros((batch, capacity, rope_dim), dtype, device, "batch",
                       "model", None),
        pos=shctx.full((capacity,), -1, torch.int32, device, None),
    )


def _mla_block(qc, qr, c, k_rope, w_uv, qpos, kpos, causal, scale):
    """One block of query rows: logits qc.c + qr.kr in fp32 (the bf16
    inputs widened, as the JAX package's ``preferred_element_type``
    does), masked, softmax in fp32 (a fully masked row gives zeros), p
    cast to c's dtype, then p.c and .w_uv. qc: [B, Q, H, r], qr: [B, Q,
    H, Dr] -> [B, Q, H, dv]."""
    lg = (torch.einsum("bqhr,bsr->bhqs", qc.float(), c.float())
          + torch.einsum("bqhd,bsd->bhqs", qr.float(), k_rope.float())
          ) * scale
    m = _mask(qpos, kpos, causal=causal)
    lg = constrain(lg, "batch", "model", None, None)
    lg = torch.where(m[:, None], lg, NEG_INF)
    mx = torch.clamp_min(lg.amax(dim=-1, keepdim=True), -1e30)
    p = torch.exp(lg - mx)
    p = (p / (p.sum(dim=-1, keepdim=True) + 1e-30)).to(c.dtype)
    p = constrain(p, "batch", "model", None, None)
    ctx = torch.einsum("bhqs,bsr->bqhr", p, c)
    return torch.einsum("bqhr,hrv->bqhv", ctx, w_uv)


def mla_attend_full(q_nope, q_rope, c, k_rope, w_uk, w_uv, qpos, kpos, *,
                    causal: bool = True, q_block: int = 512):
    """Absorbed MLA attention over full sequences (the JAX package's
    ``mla_attend_full``): ``qc = q_nope . w_uk``, logits times
    ``(dh + Dr) ** -0.5``, in blocks of ``q_block`` query rows. The JAX
    package needs Sq <= q_block or a multiple of it; here the last block
    may be short.

    q_nope: [B, Sq, H, dh], q_rope: [B, Sq, H, Dr], c: [B, Sk, r],
    k_rope: [B, Sk, Dr], w_uk: [H, dh, r], w_uv: [H, r, dv], qpos: [Sq],
    kpos: [Sk]. Returns [B, Sq, H, dv].
    """
    Sq, dh = q_nope.shape[1], q_nope.shape[-1]
    scale = (dh + q_rope.shape[-1]) ** -0.5
    qc = torch.einsum("bqhd,hdr->bqhr", q_nope, w_uk)       # absorb W_uk
    qpos, kpos = qpos[None], kpos[None]
    if Sq <= q_block:
        return _mla_block(qc, q_rope, c, k_rope, w_uv, qpos, kpos, causal,
                          scale)
    # as the JAX package's jax.checkpoint of each block: where autograd
    # records, one block's fp32 logits live at a time, not Sq x Sk of them
    return torch.cat([
        layers.recompute(_mla_block, qc[:, i:i + q_block],
                         q_rope[:, i:i + q_block], c, k_rope, w_uv,
                         qpos[:, i:i + q_block], kpos, causal, scale)
        for i in range(0, Sq, q_block)], dim=1)


def mla_cache_write(cache: MLACache, c_new, kr_new, pos: int) -> MLACache:
    """Write one token (c_new [B, 1, r], kr_new [B, 1, Dr]) at position
    ``pos`` (a host int) into slot pos % C, in place."""
    slot = pos % cache.capacity
    put(cache.c, 1, slot, c_new[:, 0].to(cache.c.dtype))
    put(cache.kr, 1, slot, kr_new[:, 0].to(cache.kr.dtype))
    put(cache.pos, 0, slot, pos)
    return cache


def mla_decode_attend(q_nope, q_rope, cache: MLACache, w_uk, w_uv,
                      pos: int):
    """One-token MLA attention against a cache; ``pos`` is the token's
    position as a host int."""
    qpos = torch.full((1,), pos, dtype=torch.int32, device=q_nope.device)
    return mla_attend_full(q_nope, q_rope, cache.c, cache.kr, w_uk, w_uv,
                           qpos, cache.pos, causal=True)
