"""The comparison that decides ``correct``: served logits against the
plain reference's, token by token."""
from __future__ import annotations

import torch


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap, over every position, by which the reference's logit
    of the token the program puts first lies below the reference's
    best."""
    served = prog.argmax(-1, keepdim=True)
    return (ref.amax(-1) - ref.gather(-1, served)[..., 0]).max().item()
