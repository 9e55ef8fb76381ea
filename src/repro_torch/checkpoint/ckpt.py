"""Checkpointing (``repro.checkpoint.ckpt``): a tree of tensors -> msgpack
(+ atomic rename), with dtype and shape round-trip including bfloat16.

The file is the JAX package's: ``{"step", "treedef", "leaves": [{"d",
"s", "b"}]}``, one leaf per array in ``jax.tree`` order (a mapping's
entries by sorted key; tuples, lists and NamedTuples in order), a
bfloat16 leaf as its uint16 bits. So a tree of dicts, tuples and
bf16 / fp32 / int32 arrays written by either package loads in the other.
``treedef`` is a description for people; neither package reads it back.

``msgpack`` is imported when a checkpoint is written or read, not when
this module is, so the rest of the package runs without it.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, List, Mapping, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> Tuple[List[Any], str]:
    """Leaves in ``jax.tree`` order and a description of the structure."""
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        desc = ", ".join(f"{k!r}: {d}" for k, (_, d) in zip(keys, parts))
        return [leaf for ls, _ in parts for leaf in ls], "{" + desc + "}"
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]
        leaves = [leaf for ls, _ in parts for leaf in ls]
        inner = ", ".join(d for _, d in parts)
        if _is_namedtuple(tree):
            return leaves, f"{type(tree).__name__}({inner})"
        return leaves, (f"({inner})" if isinstance(tree, tuple)
                        else f"[{inner}]")
    return [tree], "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, Mapping):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return type(like)((k, vals[k]) for k in like)
    if isinstance(like, (tuple, list)):
        items = [_unflatten(x, leaves) for x in like]
        if _is_namedtuple(like):
            return type(like)(*items)
        return type(like)(items)
    return next(leaves)


def _pack_leaf(x) -> dict:
    t = torch.as_tensor(x).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().view(np.uint16)
        return {"d": "bfloat16", "s": list(a.shape), "b": a.tobytes()}
    a = t.numpy()
    return {"d": a.dtype.name, "s": list(a.shape), "b": a.tobytes()}


def _unpack_leaf(d: dict) -> torch.Tensor:
    if d["d"] == "bfloat16":
        a = np.frombuffer(d["b"], np.uint16).reshape(d["s"])
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    a = np.frombuffer(d["b"], np.dtype(d["d"])).reshape(d["s"])
    return torch.from_numpy(a.copy())


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    import msgpack
    leaves, desc = _flatten(tree)
    payload = {
        "step": step,
        "treedef": f"PyTreeDef({desc})",
        "leaves": [_pack_leaf(leaf) for leaf in leaves],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(msgpack.packb(payload, use_bin_type=True))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (leaf count and shapes
    validated). Each leaf keeps the file's dtype and lands on the device
    of ``like``'s leaf (the CPU where that leaf is no tensor)."""
    import msgpack
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    leaves, _ = _flatten(like)
    stored = payload["leaves"]
    if len(stored) != len(leaves):
        raise ValueError(f"leaf count mismatch: ckpt {len(stored)} "
                         f"vs target {len(leaves)}")
    out = []
    for tgt, d in zip(leaves, stored):
        t = _unpack_leaf(d)
        if tuple(t.shape) != tuple(np.shape(tgt)):
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs "
                             f"{tuple(np.shape(tgt))}")
        if isinstance(tgt, torch.Tensor):
            t = t.to(tgt.device)
        out.append(t)
    return _unflatten(like, iter(out)), payload["step"]
