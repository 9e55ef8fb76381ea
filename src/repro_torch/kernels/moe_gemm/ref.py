"""Plain PyTorch version of the grouped expert product
(``kernel.moe_grouped_ffn_kernel``): a loop over the experts' groups of
rows, in the kernel's arithmetic (products accumulated in fp32, silu(g) *
u in fp32, rounded to the input type once before the down product and
once after it).

The JAX package has no such function: its MoE block runs every expert
over a padded buffer of C rows (``repro.models.moe._moe_ffn_block``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_grouped_ffn_ref(x: torch.Tensor, src: torch.Tensor,
                        offsets: torch.Tensor, w1: torch.Tensor,
                        w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x [T, D] tokens; src [N] the token of each row; offsets [E + 1] the
    first row of each expert's group (offsets[E] rows in all, at most N);
    w1, w3 [E, D, F], w2 [E, F, D]. Row r of expert e's group gives
    (silu(x[src[r]] w1[e]) * (x[src[r]] w3[e])) w2[e]; returns [N, D] in
    x's type, the rows past offsets[E] zero."""
    out = x.new_zeros((src.shape[0], x.shape[1]))
    bounds = offsets.tolist()
    for e, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        if a == b:
            continue
        rows = x[src[a:b]].float()
        h = F.silu(rows @ w1[e].float()) * (rows @ w3[e].float())
        out[a:b] = (h.to(x.dtype).float() @ w2[e].float()).to(x.dtype)
    return out
