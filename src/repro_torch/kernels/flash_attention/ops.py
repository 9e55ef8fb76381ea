"""Public wrapper of the flash attention kernel and its backward.

A CUDA tensor launches the Hopper kernel (or raises); a tensor on the CPU
goes to the plain version, ``ref.flash_attention_ref``, which autograd
differentiates, and so does one on the ``meta`` device (the dry-run
counts the plain version's shapes). There is no fallback from one to the
other. A ``DTensor`` (a step under a mesh) runs on its local shards
(``kernels._sharded``): batch and heads may be sharded, kv heads
replicated where Kh does not divide the model axis; a sharded sequence
or head dim raises. A CUDA call
goes through ``FlashAttention``, a ``torch.autograd.Function`` whose
forward is the kernel and whose backward is the backward kernel
(``csrc/flash_attention_bwd.cu``); where autograd does not record
(serving runs under ``inference_mode``) it builds no graph.

``flash_attention.launches`` counts the forward kernel's launches, so a
run can show that its path went through it, and
``flash_attention.launches_by_shape`` counts them per (B, H, Kh, Sq, Sk,
D), so a run that launches several shapes can tell them apart;
``flash_attention.bwd_launches`` counts the backward's kernels (each
backward call launches ``kernel.BWD_PASSES[dtype]`` of them: 2 in bf16,
3 in fp32). A CUDA graph's replay books the launches its capture counted
(``kernels._launches``), so the counters read as if it ran eagerly.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.flash_attention.kernel import (
    BWD_PASSES,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
)
from repro_torch.kernels import _launches, _sharded
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _forward(q, k, v, causal, window, chunk, scale):
    out = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 chunk=chunk, scale=scale)
    (B, H, Sq, D), (Kh, Sk) = q.shape, k.shape[1:3]
    _launches.bump(flash_attention, "launches")
    _launches.bump(flash_attention, "launches_by_shape",
                   key=(B, H, Kh, Sq, Sk, D))
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel as an autograd function: forward saves q, k and v (the
    backward recomputes the softmax statistics in fp32); backward launches
    the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, scale):
        out = _forward(q, k, v, causal, window, chunk, scale)
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, chunk=chunk,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, dout, **ctx.mask)
        _launches.bump(flash_attention, "bwd_launches", BWD_PASSES[q.dtype])
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, chunk=None,
                    scale=None):
    """q: [B, H, Sq, D]; k/v: [B, Kh, Sk, D] -> [B, H, Sq, D]."""
    if _sharded.is_sharded(q, k, v):
        op = "flash_attention"
        _sharded.check(op, q, (0, 1), "q")
        ql, kl, vl = _sharded.kv_heads_for(op, q, k, v, hdim=1)
        return _sharded.wrap(flash_attention(
            ql, kl, vl, causal=causal, window=window, chunk=chunk,
            scale=scale), q)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   chunk=chunk, scale=scale)
    return FlashAttention.apply(q, k, v, causal, window, chunk, scale)


flash_attention.launches = 0
flash_attention.launches_by_shape = collections.Counter()
flash_attention.bwd_launches = 0
