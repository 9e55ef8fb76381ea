"""Per-device cost of an eager step, counted from PyTorch's dispatcher
(``repro.launch.hlo_cost``'s counterpart: the port runs no XLA program,
so there is no HLO to walk).

``CostMode`` is a ``TorchDispatchMode`` that sees every op a step runs:

- An op on ``DTensor``s is handed back (``NotImplemented``), so DTensor's
  dispatch runs it and the ops it runs on the local shards (the
  per-device program) come back to the mode, which counts those. An op on
  fake tensors (DTensor's sharding propagation runs each op once on the
  global shapes) is not counted.
- FLOPs: ``torch.utils.flop_counter``'s formulas for the matrix products,
  convolutions and attention ops (the reference's dot FLOPs; elementwise
  ops count none, as there).
- Bytes: every counted op's tensor inputs read once and outputs written
  once. Views, metadata ops and empty allocations count none. XLA fuses
  elementwise chains into one pass over memory, so these unfused bytes
  are an upper bound on the fused program's, not its equal.
- Collectives: the ``_c10d_functional`` ops DTensor's redistributions
  run, bytes of each op's output per kind (the reference's
  ``collective_bytes``: all-gather, all-reduce, reduce-scatter,
  all-to-all), and their counts.

``resource_class_from_cost`` splits a program into compute- and
memory-bound by its arithmetic intensity against a ridge point, through
the scheduler's own classifier, so the offline and online paths cannot
disagree on the boundary.
"""
from __future__ import annotations

from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: ``_c10d_functional`` op -> the reference's collective kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_wrap_tensor_autograd"}


def resource_class_from_cost(flops: float, nbytes: float,
                             ridge: float) -> str:
    """Compute-bound vs memory-bound from a program's counted cost.

    ``ridge`` is the arch's ridge point in FLOP/byte (peak FLOP/s over
    HBM bandwidth). Delegates to the scheduler-side classifier so the
    offline (counted cost) and online (profiled kernel) paths can never
    disagree on the boundary."""
    from repro_torch.core.interference import classify_intensity
    return classify_intensity(flops, nbytes, ridge)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the per-device FLOPs, bytes and collective bytes of the ops
    run inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = defaultdict(float)
        self.collective_counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in ins):
            return out
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.collective_bytes[kind] += sum(_nbytes(o) for o in outs)
                self.collective_counts[kind] += 1
            return out
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += float(self._flops[packet](*args, **kwargs,
                                                    out_val=out))
        if func.is_view or name in _NO_BYTES:
            return out
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    def record(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts)}


def local_bytes(tree) -> int:
    """Bytes this rank holds of every tensor in a (nested) dict / tuple /
    list / module: a ``DTensor``'s local shard, a plain tensor whole, a
    host int as the int32 scalar the JAX program takes."""
    from torch import nn
    from torch.distributed.tensor import DTensor
    if isinstance(tree, nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, bool) or tree is None:
        return 0
    if isinstance(tree, int):
        return 4
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0
