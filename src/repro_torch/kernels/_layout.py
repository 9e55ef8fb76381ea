"""Layout checks shared by the kernels' bindings: the 16-byte copies that
feed shared memory (TMA, cp.async) need 16-byte-aligned addresses."""
from __future__ import annotations

import torch


def misaligned(t: torch.Tensor, align: int) -> list:
    """What keeps ``t``'s rows from being copied in ``align``-byte pieces:
    its base address, and the byte stride of each dim longer than 1 but
    the last (a dim of length 1 is never stepped over). Empty if
    nothing."""
    esz = t.element_size()
    bad = [f"data_ptr {t.data_ptr():#x}"] if t.data_ptr() % align else []
    return bad + [f"dim {i} stride {st} ({st * esz} bytes)"
                  for i, (n, st) in enumerate(zip(t.shape[:-1],
                                                  t.stride()[:-1]))
                  if n > 1 and (st * esz) % align]
