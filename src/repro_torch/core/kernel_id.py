"""Kernel identification (paper §3.2, Fig 4).

Paper: ``kernel ID = (function name, blockDim, gridDim)`` recovered via
CUDA hooks + a ``-rdynamic`` recompiled framework. The ID deliberately does
NOT include kernel inputs (they are ``void*`` at the CUDA runtime level), so
kernels with the same function and parallelization but different input
scales share an ID — mitigated by averaging (SK) + runtime feedback.

TPU/JAX adaptation: the dispatch unit is a jit-compiled program segment.
The natural analog of (name, blockDim, gridDim) is
(segment name, input shapes/dtypes, mesh fingerprint) — exactly the key JAX
uses for compiled-executable lookup, and, like the paper's ID, it is
available at dispatch time with zero measurement cost.

KernelIDs are *interned*: constructing the same (name, grid, block) returns
the same object, with the hash precomputed once. Every scheduling decision
does SK/SG dict lookups keyed by KernelID, so the per-lookup cost drops to
one cached-int hash plus (usually) an identity comparison. The intern table
is bounded by the number of distinct compiled segments — the same set JAX
keeps alive in its executable cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class KernelID:
    __slots__ = ("name", "grid", "block", "_hash")

    _intern: Dict[tuple, "KernelID"] = {}

    # paper: gridDim / blockDim | here: output / input aval fingerprints
    def __new__(cls, name: str, grid: Tuple = (), block: Tuple = ()):
        key = (name, grid, block)
        self = cls._intern.get(key)
        if self is None:
            self = object.__new__(cls)
            object.__setattr__(self, "name", name)
            object.__setattr__(self, "grid", grid)
            object.__setattr__(self, "block", block)
            object.__setattr__(self, "_hash", hash(key))
            # setdefault: safe under concurrent first-construction
            self = cls._intern.setdefault(key, self)
        return self

    def _key(self) -> tuple:
        return (self.name, self.grid, self.block)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if not isinstance(other, KernelID):
            return NotImplemented
        return self._key() == other._key()

    def __lt__(self, other) -> bool:
        if not isinstance(other, KernelID):
            return NotImplemented
        return self._key() < other._key()

    def __le__(self, other) -> bool:
        if not isinstance(other, KernelID):
            return NotImplemented
        return self._key() <= other._key()

    def __gt__(self, other) -> bool:
        if not isinstance(other, KernelID):
            return NotImplemented
        return self._key() > other._key()

    def __ge__(self, other) -> bool:
        if not isinstance(other, KernelID):
            return NotImplemented
        return self._key() >= other._key()

    def __setattr__(self, name, value):
        raise AttributeError("KernelID is immutable")

    def __delattr__(self, name):
        raise AttributeError("KernelID is immutable")

    def __reduce__(self):
        # pickle round-trips re-intern
        return (KernelID, (self.name, self.grid, self.block))

    def __repr__(self) -> str:
        return (f"KernelID(name={self.name!r}, grid={self.grid!r}, "
                f"block={self.block!r})")

    def __str__(self) -> str:
        g = "x".join(map(str, self.grid)) or "-"
        b = "x".join(map(str, self.block)) or "-"
        return f"{self.name}<<<{g},{b}>>>"

    def encode(self) -> str:
        return f"{self.name}|{self.grid}|{self.block}"


def _aval_fp(x) -> Tuple:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        dt = x.dtype
        # a torch dtype prints as "torch.bfloat16" and np.dtype() rejects
        # it; both spellings reduce to the same name, so a torch segment
        # and a JAX segment of the same avals share one KernelID
        name = (np.dtype(dt).name if isinstance(dt, np.dtype)
                else str(dt).rpartition(".")[2])
        return tuple(x.shape) + (name,)
    return (type(x).__name__,)


def kernel_id_for(name: str, inputs=(), outputs=(), mesh_fp: str = "") \
        -> KernelID:
    """Construct a KernelID from a segment name and its avals."""
    block = tuple(f for x in inputs for f in _aval_fp(x))
    grid = tuple(f for x in outputs for f in _aval_fp(x))
    if mesh_fp:
        grid = grid + (mesh_fp,)
    return KernelID(name=name, grid=grid, block=block)
