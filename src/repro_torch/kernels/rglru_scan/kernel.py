"""Binding of the Hopper RG-LRU scan kernel
(``repro_torch/csrc/rglru_scan.cu``), which replaces the Pallas TPU kernel
``repro.kernels.rglru_scan.kernel.rglru_scan_kernel``, and of its backward
(``repro_torch/csrc/rglru_scan_bwd.cu``), which has no Pallas counterpart:
the JAX package differentiates the recurrence with XLA.

The library is built and loaded on the first launch (``kernels._build``),
never at import, so the CPU tests import this module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _layout

#: the kernel's input types
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's geometry (``csrc/rglru_scan.cu``): rows of a block each
#: thread holds, most threads a CTA, the column tiles it takes
ROWS = 16
MAX_THREADS = 256
TILE_WIDTHS = (32, 16, 8)
#: the most threads a CTA that ``scan_plan`` takes
PLAN_THREADS = 192
#: the backward's geometry (``csrc/rglru_scan_bwd.cu``): it holds three
#: inputs a row, so a CTA has at most 192 threads
BWD_ROWS = 16
BWD_MAX_THREADS = 192
#: the bytes of loads a CTA of ``bwd_plan`` keeps in flight, at most
BWD_PLAN_BYTES = 24 * 1024
#: a tile's row should read at least one 32-byte sector
SECTOR = 32
#: grid dimension x and the kernel's int arguments
INT_MAX = 2 ** 31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # a, b, h0 (or null), h; dtype, B, S, W, tw, nseg, stream
    "rglru_scan_fwd": ([_P] * 4 + [_I] * 6 + [_P], ctypes.c_int),
    "rglru_scan_rows": ([], ctypes.c_int),
    "rglru_scan_error_string": ([_I], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    # a, h, dy, h0 (or null), da, db, dh0 (or null); dtype, B, S, W, tw,
    # nseg, stream
    "rglru_scan_bwd": ([_P] * 7 + [_I] * 6 + [_P], ctypes.c_int),
    "rglru_scan_bwd_rows": ([], ctypes.c_int),
    "rglru_scan_bwd_max_threads": ([], ctypes.c_int),
    "rglru_scan_bwd_error_string": ([_I], ctypes.c_char_p),
}


def library() -> ctypes.CDLL:
    """The kernel's library, built by nvcc on the first call."""
    return _build.load("rglru_scan", _SIGNATURES)


def bwd_library() -> ctypes.CDLL:
    """The backward's library, built by nvcc on the first call."""
    return _build.load("rglru_scan_bwd", _BWD_SIGNATURES)


class Plan(NamedTuple):
    """How a launch cuts [B, S, W]: CTAs of ``tw`` columns (one a lane)
    by ``nseg`` segments of ``ROWS`` (the backward: ``BWD_ROWS``) rows,
    walking S in ``blocks`` blocks of ``block_rows`` rows (the backward
    from the last); CTA i takes batch row i // tiles and column tile
    i % tiles."""
    tw: int
    nseg: int
    threads: int
    block_rows: int
    blocks: int
    tiles: int
    ctas: int


def plan_for(B: int, S: int, W: int, tw: int, nseg: int,
             rows: int = ROWS) -> Plan:
    """The launch the kernel makes for ``tw`` columns and ``nseg``
    segments of ``rows`` rows a CTA."""
    block_rows = nseg * rows
    tiles = -(-W // tw)
    return Plan(tw=tw, nseg=nseg, threads=tw * nseg, block_rows=block_rows,
                blocks=-(-S // block_rows), tiles=tiles, ctas=B * tiles)


def scan_plan(B: int, S: int, W: int, dtype: torch.dtype, sms: int) -> Plan:
    """The plan for a [B, S, W] scan of ``dtype`` on a card of ``sms``
    SMs:

    - the widest column tile whose grid still gives every SM a CTA (at
      B = 1, W = 4096: 16 columns, 256 CTAs), but none whose row reads
      less than one 32-byte sector;
    - as many segments as PLAN_THREADS threads a CTA allow, but no more
      than S needs. Each thread keeps 2 * ROWS loads in flight; on an
      H100 (``scripts/torch_rglru_plan_sweep.py``) 192 threads were the
      fastest at the hybrid's prompt (6 segments of 32 columns) and at
      B 1, S 8192 (12 of 16), against 128 and 256.
    """
    return _plan(B, S, W, dtype, sms, ROWS, PLAN_THREADS)


def bwd_plan(B: int, S: int, W: int, dtype: torch.dtype,
             sms: int) -> Plan:
    """The backward's plan: the column tile as ``scan_plan`` picks it
    (the widest that still gives every SM a CTA, none under one sector a
    row), and as many segments of ``BWD_ROWS`` rows as S needs, up to a
    CTA whose buffer of three inputs holds BWD_PLAN_BYTES (fp32: 128
    threads; bf16: 256, so BWD_MAX_THREADS, 192). On an H100
    (``scripts/torch_rglru_plan_sweep.py --bwd``) that was the fastest
    at the hybrid's train shape [2, 2100, 4096] (fp32 32 columns x 4
    segments, bf16 32 x 6) and at B 1, S 8192 (16 x 8), against 192
    threads in fp32 and fewer in bf16."""
    esz = torch.empty((), dtype=dtype).element_size()
    threads = min(BWD_MAX_THREADS, BWD_PLAN_BYTES // (3 * BWD_ROWS * esz))
    return _plan(B, S, W, dtype, sms, BWD_ROWS, threads)


def _plan(B, S, W, dtype, sms, rows, threads) -> Plan:
    esz = torch.empty((), dtype=dtype).element_size()
    widths = [tw for tw in TILE_WIDTHS if tw * esz >= SECTOR]
    tw = next((t for t in widths if B * -(-W // t) >= sms), widths[-1])
    nseg = min(threads // tw, -(-S // rows))
    return plan_for(B, S, W, tw, nseg, rows)


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
    B, S, W = a.shape
    if min(B, S, W) < 1 or max(B, S, W) > INT_MAX or (
            B * -(-W // TILE_WIDTHS[-1]) > INT_MAX):
        raise ValueError(f"rglru_scan kernel: [B, S, W] {tuple(a.shape)} "
                         f"must be non-empty, with B * ceil(W / "
                         f"{TILE_WIDTHS[-1]}) CTAs and each dim at most "
                         f"{INT_MAX}")
    if h0 is not None:
        if h0.device != a.device or h0.dtype != torch.float32:
            raise ValueError(f"rglru_scan kernel: h0 must be float32 on "
                             f"{a.device}; got {h0.dtype} on {h0.device}")
        if tuple(h0.shape) != (B, W):
            raise ValueError(f"rglru_scan kernel: h0 {tuple(h0.shape)} is "
                             f"not [B, W] of a {tuple(a.shape)}")


def rglru_scan_kernel(a, b, h0=None):
    """a/b: [B, S, W] contiguous; h0: fp32 [B, W] or None (zeros).
    Returns h [B, S, W] in a's dtype, every prefix of the recurrence."""
    _check(a, b, h0)
    B, S, W = a.shape
    plan = scan_plan(B, S, W, a.dtype, _layout.sm_count(a.device.index or 0))
    h = torch.empty_like(a)
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_fwd(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            DTYPES[a.dtype], B, S, W, plan.tw, plan.nseg, stream)
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    return h


def rglru_scan_bwd_kernel(a, h, dy, h0=None):
    """The gradients of ``rglru_scan_kernel``'s output ``h`` (saved from
    the forward) against ``dy``: (da, db) in a's dtype and shape, and
    dh0 fp32 [B, W] when ``h0`` was given (else None)."""
    _check(a, h, h0)
    if dy.shape != a.shape or dy.dtype != a.dtype or dy.device != a.device:
        raise ValueError(f"rglru_scan backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match a {tuple(a.shape)} "
                         f"{a.dtype}")
    dy = dy.contiguous()
    B, S, W = a.shape
    plan = bwd_plan(B, S, W, a.dtype, _layout.sm_count(a.device.index or 0))
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    lib = bwd_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_bwd(
            a.data_ptr(), h.data_ptr(), dy.data_ptr(),
            None if h0 is None else h0.data_ptr(), da.data_ptr(),
            db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
            DTYPES[a.dtype], B, S, W, plan.tw, plan.nseg, stream)
    if err != 0:
        msg = lib.rglru_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{err} ({msg})")
    return da, db, dh0
