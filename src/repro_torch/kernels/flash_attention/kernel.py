"""Binding of the Hopper flash attention kernel
(``repro_torch/csrc/flash_attention.cu``), which replaces the Pallas TPU
kernel ``repro.kernels.flash_attention.kernel.flash_attention_kernel``,
and of its backward (``repro_torch/csrc/flash_attention_bwd.cu``), which
has no Pallas counterpart: the JAX package differentiates its jnp
attention with XLA.

The libraries are built and loaded on the first launch (``kernels._build``),
never at import, so the CPU tests import this module without ``nvcc``.
What surrounds the launches is plain Python that the CPU tests reach: the
forward's bf16 warpgroups per CTA (``warpgroups``), the backward's launch
plan (``bwd_plan``: kernels, tiles, warpgroups, the head split that fills
the card at MQA shapes, scratch bytes) and the layout check of every
tensor the bf16 instances read or write through TMA tensor maps
(``check_tma_layout``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _layout

#: the kernel's instances: head dims and input types
HEAD_DIMS = (64, 96, 120, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: streaming multiprocessors of an H100 SXM, which ``warpgroups`` fills
SMS = 132
#: TMA's alignment of a base address and of every stride, in bytes
TMA_ALIGN = 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # q, k, v, o; dtype, B, H, Kh, Sq, Sk, D; (b, h, s) strides of q, k,
    # v, o; causal, window, chunk, scale, warpgroups, stream
    "flash_attention_fwd": ([_P] * 4 + [_I] * 7 + [_L] * 12
                            + [_I, _I, _I, ctypes.c_float, _I, _P],
                            ctypes.c_int),
    "flash_attention_error_string": ([_I], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    # q, k, v, dout, dq, dk, dv; stats, partial, counters; dtype, B, H, Kh,
    # Sq, Sk, D; 21 (b, h, s) strides of q, k, v, dout, dq, dk, dv;
    # causal, window, chunk, scale; dq_warpgroups, head_split; stream
    "flash_attention_bwd": ([_P] * 10 + [_I] * 7 + [_P]
                            + [_I, _I, _I, ctypes.c_float, _I, _I, _P],
                            ctypes.c_int),
    "flash_attention_bwd_passes": ([_I], ctypes.c_int),
    "flash_attention_bwd_error_string": ([_I], ctypes.c_char_p),
}
#: kernels one backward call launches, by dtype: fp32 (CUDA cores) lse and
#: Di, dK and dV, dQ; bf16 (wgmma) lse, Di and dQ, then dK and dV. The
#: library's ``flash_attention_bwd_passes``
BWD_PASSES = {torch.float32: 3, torch.bfloat16: 2}
#: the fp32 backward's grid dimension y is B * H (or B * Kh)
GRID_Y_MAX = 65535
#: rows of the bf16 backward's tiles (wgmma's M) and of a stats row's pad
BWD_TILE = 64
#: rows of the fp32 backward's tiles
BWD_TILE_F32 = 32


class BwdPlan(NamedTuple):
    """How one backward call is launched (``bwd_plan``)."""
    passes: int          # kernels launched, one after the other
    dq_rows: int         # query rows of a dQ CTA
    dq_warpgroups: int   # bf16: 64-row consumer warpgroups of a dQ CTA
    dq_ctas: int
    kv_keys: int         # keys of a dK/dV CTA
    head_split: int      # CTAs sharing a key tile's query heads
    kv_ctas: int
    stats_bytes: int     # fp32 lse and Di, [B * H][2][Sq padded to 64]
    partial_bytes: int   # fp32 partial dK and dV of a head split
    counter_bytes: int   # int32 arrivals per key tile of a head split


def bwd_plan(B: int, H: int, Kh: int, Sq: int, Sk: int, D: int,
             dtype) -> BwdPlan:
    """The backward's launch plan, as ``csrc/flash_attention_bwd.cu``
    launches it. bf16: the dQ kernel puts two 64-row warpgroups on a CTA
    (sharing its K/V ring) where the forward would (``warpgroups``), and
    one at D 256 (two would not fit in shared memory); a dK/dV CTA holds 128
    keys (two warpgroups of 64) at D <= 128 and 64 at D 256 (its two
    warpgroups split D). Where B * Kh * key tiles leaves SMs idle (MQA),
    the group's query heads are split across CTAs, by the smallest divisor
    of H / Kh that gives two waves (or by H / Kh), so that a banded mask's
    short tiles even out; each split's fp32 partial dK and dV goes to
    scratch and the last CTA of a key tile sums them in split order. fp32:
    the CUDA-core passes, 32-row tiles, no split."""
    sq_pad = -(-Sq // BWD_TILE) * BWD_TILE
    stats = B * H * 2 * sq_pad * 4
    if dtype == torch.float32:
        rows = BWD_TILE_F32
        return BwdPlan(BWD_PASSES[dtype], rows, 0, B * H * -(-Sq // rows),
                       rows, 1, B * Kh * -(-Sk // rows), stats, 0, 0)
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention backward: no {dtype} instance")
    wg = 1 if D > 128 else warpgroups(B, H, Sq)
    keys = BWD_TILE if D > 128 else 2 * BWD_TILE
    groups = B * Kh * -(-Sk // keys)
    G = H // Kh
    split = 1
    if groups < SMS:
        split = next((d for d in range(1, G + 1)
                      if G % d == 0 and groups * d >= 2 * SMS), G)
    d_pad = -(-D // 64) * 64
    partial = split * groups * keys * d_pad * 2 * 4 if split > 1 else 0
    return BwdPlan(BWD_PASSES[dtype], BWD_TILE * wg, wg,
                   B * H * -(-Sq // (BWD_TILE * wg)), keys, split,
                   groups * split, stats, partial,
                   groups * 4 if split > 1 else 0)


def warpgroups(B: int, H: int, Sq: int) -> int:
    """64-row consumer warpgroups per CTA of the bf16 kernel (wgmma's M is
    64): two share a CTA and its K/V ring, halving K/V traffic, once CTAs
    of 128 q rows still number at least one per SM; else one."""
    return 2 if B * H * -(-Sq // 128) >= SMS else 1


def check_tma_layout(name: str, t: torch.Tensor) -> None:
    """Raise ValueError unless ``t`` can be read (or written) through a TMA
    tensor map: a base address and every stride of a dim longer than 1 a
    multiple of 16 bytes, the last dim contiguous. Every layout of the
    paths passes (D * 2 >= 128 bytes)."""
    bad = _layout.misaligned(t, TMA_ALIGN)
    if t.stride(-1) != 1:
        bad.append(f"last-dim stride {t.stride(-1)}")
    if bad:
        raise ValueError(f"flash_attention kernel: {name} is not aligned to "
                         f"{TMA_ALIGN} bytes for TMA: {', '.join(bad)}")


def aligned_dout(dout: torch.Tensor) -> torch.Tensor:
    """``dout`` as the backward reads it: its last dim contiguous and, in
    bf16, laid out for TMA (``check_tma_layout``); a contiguous copy where
    it is not, else ``dout`` itself."""
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if (dout.dtype == torch.bfloat16
            and _layout.misaligned(dout, TMA_ALIGN)):
        dout = dout.clone(memory_format=torch.contiguous_format)
    return dout


def _strides(t: torch.Tensor) -> list:
    """(b, h, s) element strides for a tensor map; a dim of length 1 gets
    a stride TMA accepts (it is never stepped over)."""
    return [st if n > 1 else t.shape[-1]
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def library() -> ctypes.CDLL:
    """The kernel's library, built by nvcc on the first call."""
    return _build.load("flash_attention", _SIGNATURES)


def bwd_library() -> ctypes.CDLL:
    """The backward's library, built by nvcc on the first call."""
    return _build.load("flash_attention_bwd", _BWD_SIGNATURES)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D, "
                             f"got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s last dim "
                             f"must be contiguous (stride {t.stride(-1)})")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel: q, k, v on different "
                         "devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one type; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, H, _, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention kernel: k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[1] != 0:
        raise ValueError(f"flash_attention kernel: {H} query heads not a "
                         f"multiple of {k.shape[1]} kv heads")


def flash_attention_kernel(q, k, v, *, causal=True, window=None, chunk=None,
                           scale=None):
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] -> [B, H, Sq, D] in q's dtype.

    Any strides with a contiguous last dim are taken as they are (for bf16,
    multiples of 16 bytes: ``check_tma_layout``). The output is a
    [B, H, Sq, D] view of a contiguous [B, Sq, H, D] buffer, the layout
    the attention sublayer's output projection reads."""
    _check(q, k, v)
    if chunk is not None and chunk <= 0:
        raise ValueError(f"flash_attention kernel: chunk {chunk} must be > 0")
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    wg = 0
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
            check_tma_layout(name, t)
        wg = warpgroups(B, H, Sq)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPES[q.dtype], B, H, Kh, Sq, Sk, D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            int(causal), -1 if window is None else int(window),
            -1 if chunk is None else int(chunk), float(scale),
            wg, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    return o


def flash_attention_bwd_kernel(q, k, v, dout, *, causal=True, window=None,
                               chunk=None, scale=None):
    """The gradients (dq, dk, dv) of attention(q, k, v) (the forward
    kernel's function, whose statistics the backward recomputes in fp32)
    against ``dout`` [B, H, Sq, D], each of its input's shape, dtype and
    strides (a dense layout is kept, so attend's transposed views get
    transposed gradients). Any strides with a contiguous last dim are taken
    as they are (bf16: aligned for TMA, ``check_tma_layout``); ``dout`` is
    copied only where ``aligned_dout`` says. The launch follows
    ``bwd_plan``; its scratch is allocated here."""
    _check(q, k, v)
    if chunk is not None and chunk <= 0:
        raise ValueError(f"flash_attention kernel: chunk {chunk} must be > 0")
    B, H, Sq, D = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or dout.device != q.device):
        raise ValueError(f"flash_attention backward: dout "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device} "
                         f"does not match q {tuple(q.shape)} {q.dtype}")
    bf16 = q.dtype == torch.bfloat16
    if not bf16 and max(B * H, B * Kh) > GRID_Y_MAX:
        raise ValueError(f"flash_attention backward: B * H = {B * H} past "
                         f"the grid's {GRID_Y_MAX}")
    dout = aligned_dout(dout)
    scale = scale if scale is not None else D ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if bf16:
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout),
                        ("dq", dq), ("dk", dk), ("dv", dv)):
            check_tma_layout(name, t)
    plan = bwd_plan(B, H, Kh, Sq, Sk, D, q.dtype)
    stats = torch.empty(plan.stats_bytes // 4, dtype=torch.float32,
                        device=q.device)
    partial = torch.empty(plan.partial_bytes // 4, dtype=torch.float32,
                          device=q.device) if plan.partial_bytes else None
    counters = torch.empty(plan.counter_bytes // 4, dtype=torch.int32,
                           device=q.device) if plan.counter_bytes else None
    strides = (ctypes.c_int64 * 21)(*[
        st for t in (q, k, v, dout, dq, dk, dv) for st in _strides(t)])
    lib = bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(),
            DTYPES[q.dtype], B, H, Kh, Sq, Sk, D,
            ctypes.cast(strides, ctypes.c_void_p), int(causal),
            -1 if window is None else int(window),
            -1 if chunk is None else int(chunk), float(scale),
            plan.dq_warpgroups, plan.head_split, stream)
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err} ({msg})")
    return dq, dk, dv
