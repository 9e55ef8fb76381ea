"""Public wrapper of the RG-LRU scan kernel.

A CUDA tensor launches the Hopper kernel (or raises); a tensor on the CPU
goes to the plain version, ``ref.rglru_scan_ref``. There is no fallback
from one to the other. ``rglru_scan.launches`` counts the kernel's
launches, so a run can show that its path went through it.
"""
from __future__ import annotations

import threading

from repro_torch.kernels.rglru_scan.kernel import rglru_scan_kernel
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_count_lock = threading.Lock()


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1. a/b: [B, S, W]; h0: [B, W]
    or None. Returns [B, S, W] in a's dtype."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    out = rglru_scan_kernel(a, b, h0)
    with _count_lock:
        rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
