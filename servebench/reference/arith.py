"""The arithmetic the plain references compute in.

``Arith()`` is float32 with TF32 off, the reference itself. ``Arith(fp8=
True)`` is the control: every matrix product takes both operands rounded
to float8 e4m3 with one scale per operand (its largest magnitude mapped
to 448, the format's largest finite value) and accumulates in float32, as
an fp8 GEMM does. That is the precision below bfloat16, the one the
configurations state, which a later change might be tempted to serve in.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 under a per-tensor scale."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """Matrix products of the reference (``mm``); float32 otherwise."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return fp8_round(a) @ fp8_round(b)
        return a @ b
