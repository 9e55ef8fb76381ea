"""Public wrapper of the flash attention kernel.

A CUDA tensor launches the Hopper kernel (or raises); a tensor on the CPU
goes to the plain version, ``ref.flash_attention_ref``. There is no
fallback from one to the other. ``flash_attention.launches`` counts the
kernel's launches, so a run can show that its path went through it, and
``flash_attention.launches_by_shape`` counts them per (B, H, Kh, Sq, Sk,
D), so a run that launches several shapes can tell them apart.
"""
from __future__ import annotations

import collections
import threading

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_count_lock = threading.Lock()


def flash_attention(q, k, v, *, causal=True, window=None, chunk=None,
                    scale=None):
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] -> [B, H, Sq, D]."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   chunk=chunk, scale=scale)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 chunk=chunk, scale=scale)
    with _count_lock:
        flash_attention.launches += 1
        (B, H, Sq, D), (Kh, Sk) = q.shape, k.shape[1:3]
        flash_attention.launches_by_shape[(B, H, Kh, Sq, Sk, D)] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_shape = collections.Counter()
