"""Public wrapper of the grouped expert product.

A CUDA tensor launches the two kernels of ``csrc/moe_grouped_gemm.cu``
through ``kernel.py`` (or raises); a tensor on the CPU goes to the plain
version, ``ref.moe_grouped_ffn_ref``; one on the ``meta`` device (the
dry-run) gets products of the same shapes and operations, as if every row
were one expert's. There is no fallback from one to the other. The MoE block calls
it only where autograd does not record (``models.moe``), so it has no
backward.

``moe_grouped_ffn.launches`` counts the kernels launched (two a call), so
a run can show that its path went through them; a CUDA graph's replay
books the launches its capture counted (``kernels._launches``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _launches
from repro_torch.kernels.moe_gemm.kernel import moe_grouped_ffn_kernel
from repro_torch.kernels.moe_gemm.ref import moe_grouped_ffn_ref

#: kernels a call launches
KERNELS_A_CALL = 2


def moe_grouped_ffn(x: torch.Tensor, src: torch.Tensor,
                    offsets: torch.Tensor, w1: torch.Tensor,
                    w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x [T, D] tokens; src [N] int64, the token of each row; offsets
    [E + 1] int32, the first row of each expert's group; w1, w3 [E, D, F],
    w2 [E, F, D]. Row r of expert e's group is (silu(x[src[r]] w1[e]) *
    (x[src[r]] w3[e])) w2[e]; returns [N, D] in x's type, whose rows from
    offsets[E] on are not defined."""
    if x.device.type == "meta":
        a = x.new_empty((src.shape[0], x.shape[1]))
        return (F.silu(a @ w1[0]) * (a @ w3[0])) @ w2[0]
    if x.device.type == "cpu":
        return moe_grouped_ffn_ref(x, src, offsets, w1, w3, w2)
    out = moe_grouped_ffn_kernel(x, src, offsets, w1, w3, w2)
    _launches.bump(moe_grouped_ffn, "launches", KERNELS_A_CALL)
    return out


moe_grouped_ffn.launches = 0
