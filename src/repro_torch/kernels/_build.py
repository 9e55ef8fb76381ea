"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root of
the checkout, on first use, then loaded with ``ctypes``. The library's file
name carries a hash of the source and the flags, so a stale build is never
reused. Loading is serialised by a lock: the measurement engine's device
thread and the sharing engine's may both be first to launch a kernel.
``build_all`` starts one ``nvcc`` per source at once, so a fresh checkout
pays for the slowest build, not the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built from source at "
                           "first use")
    return path


def built_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to: named by the hash of the
    source and the flags. ptxas's ``-v`` report lies beside it, with the
    suffix ``.log``."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library built from the same
    source and flags (named by their hash) is already there."""
    out = built_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {res.returncode}):\n{res.stderr}")
    # ptxas -v: registers, shared memory and spills of every instance
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` that is not built yet, one nvcc
    process per source, all started together; returns the libraries."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(_build, names)))


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library,
    its C functions typed from ``signatures`` ({function: (argtypes,
    restype)}) before any caller sees it."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
