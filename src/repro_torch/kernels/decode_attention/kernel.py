"""Binding of the Hopper decode attention kernel
(``repro_torch/csrc/decode_attention.cu``), which replaces the Pallas TPU
kernel ``repro.kernels.decode_attention.kernel.decode_attention_kernel``.

The library is built and loaded on the first launch (``kernels._build``),
never at import, so the CPU tests import this module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import operator
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _layout

#: the kernel's instances: head dims, input types, most query heads per
#: kv head
HEAD_DIMS = (64, 120, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 64
#: the bf16 kernel's geometry (``csrc/decode_attention.cu``): cache slots
#: per tile (a split is whole tiles), query heads per CTA (one m16 row
#: tile), warps per CTA, ring stages per warp
TILE = 16
HEAD_TILE = 16
WARPS = 4
STAGES = 3
#: shared memory a CTA may have, and what an SM has beside 1 KB reserved
#: per CTA (H100)
SMEM_LIMIT = 227 * 1024
SM_SMEM = 228 * 1024
#: fp32 partials (written, then read by the combine) at most this share of
#: the bf16 cache's bytes
PARTIAL_SHARE = 4
#: cp.async copies 16 bytes from 16-byte-aligned addresses
ASYNC_ALIGN = 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # q, k, v, kpos, o, m_part, l_part, acc_part; dtype, B, H, Kh, C, D;
    # (b, h) strides of q, (b, h, c) of k and v, (b, h) of o; pos, window,
    # chunk, scale, splits, split_len, stream
    "decode_attention_fwd": ([_P] * 8 + [_I] * 6 + [_L] * 10
                             + [_I, _I, _I, ctypes.c_float, _I, _I, _P],
                             ctypes.c_int),
    # dtype, D, G -> dynamic shared memory of one split CTA
    "decode_attention_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "decode_attention_error_string": ([_I], ctypes.c_char_p),
}


def library() -> ctypes.CDLL:
    """The kernel's library, built by nvcc on the first call."""
    return _build.load("decode_attention", _SIGNATURES)


def padded(D: int) -> int:
    """The head dim a bf16 tile row holds: D rounded up to the mma's k of
    16 (D 120: 128, the padding zero)."""
    return -(-D // 16) * 16


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one bf16 CTA (the kernel's ``TcLayout``):
    the Q tile, each warp's ring of (K, V) tiles with rows of
    ``padded(D)`` columns and 16 bytes more, their kpos, and each warp's
    (m, l) per row."""
    row = 2 * padded(D) + 16
    tile = TILE * row
    return (HEAD_TILE * row + WARPS * STAGES * 2 * tile
            + WARPS * STAGES * TILE * 4 + 2 * WARPS * HEAD_TILE * 4)


class Plan(NamedTuple):
    """How a launch cuts the work: ``splits`` ranges of ``split_len``
    slots (whole tiles) times ``head_tiles`` m16 tiles of a kv head's
    query heads, per (batch, kv head) group."""
    splits: int
    split_len: int
    head_tiles: int
    ctas: int
    ctas_per_sm: int
    stages: int
    smem_bytes: int
    partial_bytes: int
    partial_limit: int


def split_plan(groups: int, G: int, C: int, D: int, sms: int) -> Plan:
    """The split-KV plan for ``groups`` = B * Kh (batch, kv head) pairs of
    G query heads each over a cache of C slots of head dim D, on a card
    of ``sms`` SMs, chosen from bytes:

    - about one wave: as many CTAs as the SMs hold at once (by shared
      memory), so every SM streams the cache and none waits for a second
      round;
    - every warp gets at least one 16-slot tile (a warp streams its share
      through a ring of STAGES tiles; where the cache is short every tile
      of every warp is in flight at once);
    - the fp32 partials, splits * G * D * 4 bytes per group, written and
      read again by the combine, at most 1 / PARTIAL_SHARE of the bf16
      cache's 2 * C * D * 2 bytes per group.
    """
    head_tiles = -(-G // HEAD_TILE)
    rows = groups * head_tiles
    tiles = -(-C // TILE)
    smem = smem_bytes(D)
    per_sm = max(1, SM_SMEM // (smem + 1024))
    wave = max(1, sms * per_sm // rows)
    every_warp = max(1, tiles // WARPS)
    partial_cap = max(1, C // (PARTIAL_SHARE * G))
    want = min(wave, every_warp, partial_cap)
    split_len = TILE * -(-tiles // want)
    splits = -(-C // split_len)
    return Plan(splits=splits, split_len=split_len, head_tiles=head_tiles,
                ctas=splits * rows, ctas_per_sm=per_sm, stages=STAGES,
                smem_bytes=smem, partial_bytes=splits * G * D * 4 * groups,
                partial_limit=max(2 * C * D * 2 * groups // PARTIAL_SHARE,
                                  G * D * 4 * groups))


def check_async_layout(name: str, t: torch.Tensor) -> None:
    """Raise ValueError unless the bf16 kernel can copy ``t``'s rows with
    16-byte cp.async: a base address and every stride of a dim longer
    than 1 a multiple of 16 bytes. The model's caches pass (a row is
    D * 2 >= 128 bytes)."""
    bad = _layout.misaligned(t, ASYNC_ALIGN)
    if bad:
        raise ValueError(f"decode_attention kernel: {name} is not aligned to "
                         f"{ASYNC_ALIGN} bytes for cp.async: {', '.join(bad)}")


def _check(q, k, v, kpos) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("kpos", kpos)):
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention kernel: {name}'s last dim "
                             f"must be contiguous (stride {t.stride(-1)})")
    if not (q.device == k.device == v.device == kpos.device):
        raise ValueError("decode_attention kernel: q, k, v, kpos on "
                         "different devices")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention kernel: q {tuple(q.shape)} "
                         f"must be [B, H, D] and k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} one [B, Kh, C, D] shape")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one type; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, H, D = q.shape
    Kh, C = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention kernel: k/v {tuple(k.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if H % Kh != 0 or H // Kh > MAX_GROUP:
        raise ValueError(f"decode_attention kernel: {H} query heads over "
                         f"{Kh} kv heads (at most {MAX_GROUP} per kv head)")
    if kpos.dtype != torch.int32 or tuple(kpos.shape) != (C,):
        raise ValueError(f"decode_attention kernel: kpos must be int32 "
                         f"[{C}], got {kpos.dtype} {tuple(kpos.shape)}")
    if q.dtype == torch.bfloat16:
        for name, t in (("k", k), ("v", v), ("kpos", kpos)):
            check_async_layout(name, t)


def decode_attention_kernel(q, k, v, kpos, pos: int, *, window=None,
                            chunk=None, scale=None):
    """q: [B, H, D]; k/v: [B, Kh, C, D] with any strides whose last dim is
    contiguous (the model's [B, C, Kh, D] cache as a transposed view);
    kpos: int32 [C] on the card; pos: the query's position as a host int.
    Returns [B, H, D] in q's dtype."""
    _check(q, k, v, kpos)
    # a tensor would cost a device sync per call to read
    if isinstance(pos, torch.Tensor) or operator.index(pos) < 0:
        raise ValueError(f"decode_attention kernel: pos must be a host int "
                         f">= 0, got {pos!r}")
    pos = operator.index(pos)
    if chunk is not None and chunk <= 0:
        raise ValueError(f"decode_attention kernel: chunk {chunk} must be "
                         f"> 0")
    B, H, D = q.shape
    Kh, C = k.shape[1], k.shape[2]
    G = H // Kh
    scale = scale if scale is not None else D ** -0.5
    plan = split_plan(B * Kh, G, C, D, _layout.sm_count(q.device.index or 0))
    splits = plan.splits
    dev = q.device
    o = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    m_part = torch.empty(B * Kh * splits * G, dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty(B * Kh * splits * G * D, dtype=torch.float32,
                           device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
            o.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), DTYPES[q.dtype], B, H, Kh, C, D,
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:2], pos, -1 if window is None else int(window),
            -1 if chunk is None else int(chunk), float(scale), splits,
            plan.split_len, stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    return o
