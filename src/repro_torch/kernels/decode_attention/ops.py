"""Public wrapper of the decode attention kernel.

A CUDA tensor launches the Hopper kernel (or raises); a tensor on the CPU
goes to the plain version, ``ref.decode_attention_ref``, and so does one
on the ``meta`` device (the dry-run). There is no fallback from one to
the other. A ``DTensor`` (a step under a mesh) runs on its local shards
(``kernels._sharded``): batch and heads may be sharded, kv heads
replicated where Kh does not divide the model axis. A cache sharded on
its sequence dim (the JAX package's layout when Kh does not divide) is
all-gathered first: the kernel's split-KV combine is not run across
ranks. ``decode_attention.launches`` counts the
kernel's launches, so a run can show that its path went through it.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_kernel,
)
from repro_torch.kernels import _launches, _sharded
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, kpos, pos: int, *, window=None, chunk=None,
                     scale=None):
    """q: [B, H, D]; k/v: [B, Kh, C, D]; kpos: int32 [C]; pos: host int.
    Returns [B, H, D]."""
    if _sharded.is_sharded(q, k, v, kpos):
        op = "decode_attention"
        _sharded.check(op, q, (0, 1), "q")
        _sharded.check(op, k, (0, 1, 2), "k")
        _sharded.check(op, kpos, (0,), "kpos")
        k, v = _sharded.gather_dims(k, (2,)), _sharded.gather_dims(v, (2,))
        kpos = _sharded.gather_dims(kpos, (0,)).to_local()
        ql, kl, vl = _sharded.kv_heads_for(op, q, k, v, hdim=1)
        return _sharded.wrap(decode_attention(
            ql, kl, vl, kpos, pos, window=window, chunk=chunk, scale=scale),
            q)
    if q.device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k, v, kpos, pos, window=window,
                                    chunk=chunk, scale=scale)
    out = decode_attention_kernel(q, k, v, kpos, pos, window=window,
                                  chunk=chunk, scale=scale)
    _launches.bump(decode_attention, "launches")
    return out


decode_attention.launches = 0
