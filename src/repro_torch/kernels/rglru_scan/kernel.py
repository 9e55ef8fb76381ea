"""Binding of the Hopper RG-LRU scan kernel
(``repro_torch/csrc/rglru_scan.cu``), which replaces the Pallas TPU kernel
``repro.kernels.rglru_scan.kernel.rglru_scan_kernel``.

The library is built and loaded on the first launch (``kernels._build``),
never at import, so the CPU tests import this module without ``nvcc``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the kernel's input types
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # a, b, h0 (or null), h; dtype, B, S, W, stream
    "rglru_scan_fwd": ([_P] * 4 + [_I] * 4 + [_P], ctypes.c_int),
    "rglru_scan_error_string": ([_I], ctypes.c_char_p),
}


def library() -> ctypes.CDLL:
    """The kernel's library, built by nvcc on the first call."""
    return _build.load("rglru_scan", _SIGNATURES)


def _check(a, b, h0) -> None:
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"rglru_scan kernel: {name} is on {t.device}, "
                             f"not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan kernel: {name} must be "
                             f"contiguous")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan kernel: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one [B, S, W] shape")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"rglru_scan kernel takes float32 or bfloat16 a, b "
                        f"of one type; got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("rglru_scan kernel: a and b on different devices")
    if h0 is not None:
        if h0.device != a.device or h0.dtype != torch.float32:
            raise ValueError(f"rglru_scan kernel: h0 must be float32 on "
                             f"{a.device}; got {h0.dtype} on {h0.device}")
        if tuple(h0.shape) != (a.shape[0], a.shape[2]):
            raise ValueError(f"rglru_scan kernel: h0 {tuple(h0.shape)} is "
                             f"not [B, W] of a {tuple(a.shape)}")


def rglru_scan_kernel(a, b, h0=None):
    """a/b: [B, S, W] contiguous; h0: fp32 [B, W] or None (zeros).
    Returns h [B, S, W] in a's dtype, every prefix of the recurrence."""
    _check(a, b, h0)
    B, S, W = a.shape
    h = torch.empty_like(a)
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_fwd(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            DTYPES[a.dtype], B, S, W, stream)
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    return h
