"""Binding of the Hopper decode attention kernel
(``repro_torch/csrc/decode_attention.cu``), which replaces the Pallas TPU
kernel ``repro.kernels.decode_attention.kernel.decode_attention_kernel``.

The library is built and loaded on the first launch (``kernels._build``),
never at import, so the CPU tests import this module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import _build

#: the kernel's instances: head dims, input types, most query heads per
#: kv head, cache slots per tile (a split is a multiple of it)
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 64
TILE = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # q, k, v, kpos, o, m_part, l_part, acc_part; dtype, B, H, Kh, C, D;
    # (b, h) strides of q, (b, h, c) of k and v, (b, h) of o; pos, window,
    # chunk, scale, splits, split_len, stream
    "decode_attention_fwd": ([_P] * 8 + [_I] * 6 + [_L] * 10
                             + [_I, _I, _I, ctypes.c_float, _I, _I, _P],
                             ctypes.c_int),
    "decode_attention_error_string": ([_I], ctypes.c_char_p),
}


def library() -> ctypes.CDLL:
    """The kernel's library, built by nvcc on the first call."""
    return _build.load("decode_attention", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(groups: int, C: int, sms: int):
    """(splits, split_len) for ``groups`` = B * Kh CTA rows over a cache
    of C slots: about two CTAs per SM, each split a whole number of
    ``TILE``-slot tiles, and no split past the end of the cache."""
    tiles = -(-C // TILE)
    want = max(1, -(-2 * sms // groups))
    per = -(-tiles // min(want, tiles))
    split_len = per * TILE
    return -(-C // split_len), split_len


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
    splits, split_len = split_plan(B * Kh, C, _sm_count(q.device.index or 0))
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
            split_len, stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    return o
