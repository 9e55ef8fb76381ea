"""Public wrapper of the decode attention kernel.

A CUDA tensor launches the Hopper kernel (or raises); a tensor on the CPU
goes to the plain version, ``ref.decode_attention_ref``. There is no
fallback from one to the other. ``decode_attention.launches`` counts the
kernel's launches, so a run can show that its path went through it.
"""
from __future__ import annotations

import threading

from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_kernel,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_count_lock = threading.Lock()


def decode_attention(q, k, v, kpos, pos: int, *, window=None, chunk=None,
                     scale=None):
    """q: [B, H, D]; k/v: [B, Kh, C, D]; kpos: int32 [C]; pos: host int.
    Returns [B, H, D]."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kpos, pos, window=window,
                                    chunk=chunk, scale=scale)
    out = decode_attention_kernel(q, k, v, kpos, pos, window=window,
                                  chunk=chunk, scale=scale)
    with _count_lock:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
