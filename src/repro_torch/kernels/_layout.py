"""What the kernels' bindings share: layout checks (the 16-byte copies
that feed shared memory, TMA and cp.async, need 16-byte-aligned
addresses) and the card's SM count, which their launch plans fill."""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
