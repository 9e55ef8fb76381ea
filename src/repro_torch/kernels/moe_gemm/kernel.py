"""Binding of the Hopper grouped expert product
(``repro_torch/csrc/moe_grouped_gemm.cu``). It replaces no Pallas kernel:
the JAX package runs its experts as batched products over a padded [E, C,
D] buffer (``repro.models.moe._moe_ffn_block``), which at dropless capacity
(C = T) computes E / k times the routed work. Here each expert runs over
its own rows only, in two kernels a call over N rows grouped by expert
(the rows of expert e are offsets[e] .. offsets[e + 1]):

- ``moe_grouped_gate_up``: H[r] = silu(x[src[r]] w1[e]) * (x[src[r]] w3[e]),
  gathering the token rows itself (no [N, D] copy of the entries);
- ``moe_grouped_down``: O[r] = H[r] w2[e].

bf16 runs on the tensor cores (wgmma fed by TMA and cp.async rings), fp32
on the CUDA cores. The grid is fixed for the worst case (ceil(N / BM) + E
row tiles by the column tiles), so a CUDA graph captured once is right for
any routing: each CTA finds its group from the offsets on the device and
one past the last tile does no work. Nothing is read back to the host.

The library is built and loaded on the first launch (``kernels._build``),
never at import, so the CPU tests import this module without ``nvcc``.
Loading it reads ptxas's report of every instance (``instances``) and
raises where one spills.
"""
from __future__ import annotations

import ctypes
import re
import threading
from typing import Dict

import torch

from repro_torch.kernels import _build, _layout

#: the instances' input types
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: D and F must be multiples of this: a k step never straddles two experts
K_STEP = 64
#: the 16-byte copies (TMA, cp.async, float4) need aligned rows
ALIGN = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, src, offsets, w1, w3, w2, h, o; dtype, N, D, F, E; stream
    "moe_grouped_ffn": ([_P] * 8 + [_I] * 5 + [_P], ctypes.c_int),
    "moe_grouped_ffn_error_string": ([_I], ctypes.c_char_p),
}
_lock = threading.Lock()
#: registers and spill bytes of each kernel instance, from ptxas
_instances: Dict[str, dict] = {}


def parse_ptxas(log: str) -> Dict[str, dict]:
    """{instance: {"registers", "spill_bytes"}} of the grouped product's
    kernels in a ptxas ``-v`` report: ``tc`` (bf16) and ``simt`` (fp32)
    instances of ``moe_grouped_gate_up`` and ``moe_grouped_down``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"(tc|simt)\d+(moe_grouped_(?:gate_up|down))",
                          m.group(1))
            name = f"{t.group(2)} {t.group(1)}" if t else None
            if name:
                out[name] = {"registers": None, "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def library() -> ctypes.CDLL:
    """The kernels' library, built by nvcc on the first call; raises if an
    instance spills registers."""
    lib = _build.load("moe_grouped_gemm", _SIGNATURES)
    with _lock:
        if not _instances:
            path = _build.built_path("moe_grouped_gemm")
            found = parse_ptxas(path.with_suffix(".log").read_text())
            spilled = {k: v for k, v in found.items() if v["spill_bytes"]}
            if spilled:
                raise RuntimeError(f"moe_grouped_gemm.cu spills registers: "
                                   f"{spilled}")
            _instances.update(found)
    return lib


def instances() -> Dict[str, dict]:
    """Registers and spill bytes of each built instance (empty before the
    first launch)."""
    with _lock:
        return dict(_instances)


def moe_grouped_ffn_kernel(x: torch.Tensor, src: torch.Tensor,
                           offsets: torch.Tensor, w1: torch.Tensor,
                           w3: torch.Tensor, w2: torch.Tensor
                           ) -> torch.Tensor:
    """x [T, D]; src [N] int64, the token of each row; offsets [E + 1]
    int32 on the device, the groups' first rows (offsets[E] <= N); w1, w3
    [E, D, F], w2 [E, F, D]. Returns [N, D] in x's type; rows from
    offsets[E] on are not written."""
    N, (T, D), (E, D1, F) = src.shape[0], x.shape, w1.shape
    tensors = dict(x=x, src=src, offsets=offsets, w1=w1, w3=w3, w2=w2)
    for name, t in tensors.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"moe_grouped_ffn: {name} on {t.device}, "
                             f"x on {x.device}; all must be on one card")
        if not t.is_contiguous():
            raise ValueError(f"moe_grouped_ffn: {name} is not contiguous")
        if t.dim() > 1 and _layout.misaligned(t, ALIGN):
            raise ValueError(f"moe_grouped_ffn: {name} is not aligned to "
                             f"{ALIGN} bytes")
    if x.dtype not in DTYPES or {w1.dtype, w3.dtype, w2.dtype} != {x.dtype}:
        raise ValueError(f"moe_grouped_ffn: x {x.dtype}, weights "
                         f"{w1.dtype}/{w3.dtype}/{w2.dtype}; one of "
                         f"{tuple(DTYPES)} for all")
    if (D1, tuple(w3.shape), tuple(w2.shape)) != (D, (E, D, F), (E, F, D)):
        raise ValueError(f"moe_grouped_ffn: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w3 {tuple(w3.shape)}, w2 "
                         f"{tuple(w2.shape)}")
    if D % K_STEP or F % K_STEP:
        raise ValueError(f"moe_grouped_ffn: D {D} and F {F} must be "
                         f"multiples of {K_STEP}")
    if src.dtype != torch.int64 or offsets.dtype != torch.int32 or (
            tuple(offsets.shape) != (E + 1,)):
        raise ValueError(f"moe_grouped_ffn: src {src.dtype}, offsets "
                         f"{offsets.dtype} {tuple(offsets.shape)}; want "
                         f"int64 and int32 [{E + 1}]")
    h = x.new_empty((N, F))
    o = x.new_empty((N, D))
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_grouped_ffn(
            x.data_ptr(), src.data_ptr(), offsets.data_ptr(), w1.data_ptr(),
            w3.data_ptr(), w2.data_ptr(), h.data_ptr(), o.data_ptr(),
            DTYPES[x.dtype], N, D, F, E, stream)
    if err != 0:
        msg = lib.moe_grouped_ffn_error_string(err).decode()
        raise RuntimeError(f"moe_grouped_ffn launch failed: CUDA error "
                           f"{err} ({msg})")
    return o
