"""Weight bridge from the JAX package: its parameter pytree, given as
nested dicts of numpy arrays, becomes the port's state dict.

The caller converts the JAX arrays (``jax.tree.map(np.asarray, params)``);
this module imports no JAX. Dtypes and shapes are kept: a bfloat16 array
(numpy's ml_dtypes extension type) is reinterpreted bit for bit. The
stacked ``layers`` subtree ([L, ...] leaves: the dense decoder's and the
mamba2 SSM's) is split into ``layers.<i>``;
a list of per-block subtrees (the hybrid's ``blocks``) becomes
``blocks.<i>``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16)).view(torch.bfloat16)
    return torch.tensor(a)


def params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """Flatten the JAX tree to state-dict keys of the port's model
    (``Transformer``, ``Mamba2`` or ``Hybrid``)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for name, child in node.items():
                walk(f"{prefix}{name}.", child)
            return
        if isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{prefix}{i}.", child)
            return
        key = prefix[:-1]
        if key.startswith("layers."):
            rest = key[len("layers."):]
            for i in range(node.shape[0]):
                out[f"layers.{i}.{rest}"] = _tensor(node[i])
        else:
            out[key] = _tensor(node)

    walk("", tree)
    return out
