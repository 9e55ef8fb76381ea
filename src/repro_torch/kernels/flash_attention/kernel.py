"""Binding of the Hopper flash attention kernel
(``repro_torch/csrc/flash_attention.cu``), which replaces the Pallas TPU
kernel ``repro.kernels.flash_attention.kernel.flash_attention_kernel``,
and of its backward (``repro_torch/csrc/flash_attention_bwd.cu``), which
has no Pallas counterpart: the JAX package differentiates its jnp
attention with XLA.

The library is built and loaded on the first launch (``kernels._build``),
never at import, so the CPU tests import this module without ``nvcc``.
What surrounds the launch is plain Python that the CPU tests reach: the
bf16 instances' warpgroups per CTA (``warpgroups``) and their layout
check, since their loads go through TMA tensor maps
(``check_tma_layout``).
"""
from __future__ import annotations

import ctypes

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
    # q, k, v, dout, dq, dk, dv, lse, di; dtype, B, H, Kh, Sq, Sk, D;
    # 21 (b, h, s) strides of q, k, v, dout, dq, dk, dv; causal, window,
    # chunk, scale, stream
    "flash_attention_bwd": ([_P] * 9 + [_I] * 7 + [_P]
                            + [_I, _I, _I, ctypes.c_float, _P],
                            ctypes.c_int),
    "flash_attention_bwd_passes": ([], ctypes.c_int),
    "flash_attention_bwd_error_string": ([_I], ctypes.c_char_p),
}
#: kernels one backward call launches (lse and Di; dK and dV; dQ), the
#: library's ``flash_attention_bwd_passes``
BWD_PASSES = 3
#: the backward's grid dimension y is B * H (or B * Kh)
GRID_Y_MAX = 65535


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
    kernel's function, which the backward recomputes in fp32) against
    ``dout`` [B, H, Sq, D], each of its input's shape, dtype and strides
    (a dense layout is kept, so attend's transposed views get transposed
    gradients). Any strides with a contiguous last dim are taken as they
    are; ``dout`` is copied only if its last dim is not contiguous."""
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
    if max(B * H, B * Kh) > GRID_Y_MAX:
        raise ValueError(f"flash_attention backward: B * H = {B * H} past "
                         f"the grid's {GRID_Y_MAX}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    scale = scale if scale is not None else D ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    di = torch.empty_like(lse)
    strides = (ctypes.c_int64 * 21)(*[
        st for t in (q, k, v, dout, dq, dk, dv) for st in _strides(t)])
    lib = bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            di.data_ptr(), DTYPES[q.dtype], B, H, Kh, Sq, Sk, D,
            ctypes.cast(strides, ctypes.c_void_p), int(causal),
            -1 if window is None else int(window),
            -1 if chunk is None else int(chunk), float(scale), stream)
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err} ({msg})")
    return dq, dk, dv
