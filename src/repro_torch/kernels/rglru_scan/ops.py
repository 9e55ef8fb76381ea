"""Public wrapper of the RG-LRU scan kernel and its backward.

A CUDA tensor launches the Hopper kernel (or raises); a tensor on the CPU
goes to the plain version, ``ref.rglru_scan_ref``, which autograd
differentiates; one on the ``meta`` device (the dry-run) gets an
elementwise form of the same shapes and traffic.
There is no fallback from one to the other. A ``DTensor`` (a step under a
mesh) runs on its local shards (``kernels._sharded``): the recurrence is
elementwise over batch and width, so either may be sharded; a sharded
sequence dim raises. A CUDA call
goes through ``RGLRUScan``, a ``torch.autograd.Function`` whose forward is
the kernel and whose backward is the backward kernel
(``csrc/rglru_scan_bwd.cu``); where autograd does not record it builds no
graph. ``rglru_scan.launches`` counts the forward
kernel's launches and ``rglru_scan.bwd_launches`` the backward's, so a
run can show that its path went through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import (
    rglru_scan_bwd_kernel,
    rglru_scan_kernel,
)
from repro_torch.kernels import _launches, _sharded
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def _forward(a, b, h0):
    out = rglru_scan_kernel(a, b, h0)
    _launches.bump(rglru_scan, "launches")
    return out


class RGLRUScan(torch.autograd.Function):
    """The kernel as an autograd function: forward saves a, h0 and the
    output h; backward launches the backward kernel."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _forward(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd_kernel(a, h, dh, h0)
        _launches.bump(rglru_scan, "bwd_launches")
        return da, db, dh0


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1. a/b: [B, S, W]; h0: [B, W]
    or None. Returns [B, S, W] in a's dtype."""
    if _sharded.is_sharded(a, b, h0):
        op = "rglru_scan"
        _sharded.check(op, a, (0, 2), "a")
        _sharded.same(op, a, b, "b")
        if h0 is not None:
            want = [p if not (hasattr(p, "dim") and p.dim == 2)
                    else type(p)(1) for p in a.placements]
            if list(h0.placements) != want:
                raise NotImplementedError(
                    f"{op}: h0 placed {list(h0.placements)}, unlike a's "
                    f"[B, W] placements {want}")
            h0 = h0.to_local()
        return _sharded.wrap(rglru_scan(a.to_local(), b.to_local(), h0), a)
    if a.device.type == "meta":
        # shapes only (the dry-run): one elementwise pass over a, b (and
        # h0) writing h, the kernel's traffic, not the plain version's
        # S-step loop
        h = a.float() * b.float()
        return (h if h0 is None else h + h0.float()[:, None]).to(a.dtype)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    return RGLRUScan.apply(a, b, h0)


rglru_scan.launches = 0
rglru_scan.bwd_launches = 0
