"""Mesh context (``repro.sharding.context``): lets model code (the MoE
expert-parallel block, the sharding constraints) know which mesh the
surrounding step runs on without threading it through every call.

The launch layer sets the context; model code queries it. With no mesh set
(unit tests, serving) the single-device code path is used, on plain
tensors.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` (or a device-free
``launch.mesh.MeshShape``): its axis names are ``mesh_dim_names``. Under
a mesh the step's parameters and activations are ``DTensor``s, and
``constrain`` is ``DTensor.redistribute``: in eager PyTorch a constraint
is a real redistribution, run where it is written (collectives included),
not a hint to a partitioner as ``with_sharding_constraint`` is to GSPMD.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

_state = threading.local()


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    return mesh.shape[axis_names(mesh).index(name)]


def set_mesh(mesh) -> None:
    _state.mesh = mesh


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def batch_axes() -> Optional[Tuple[str, ...]]:
    """Mesh axes over which the global batch is sharded."""
    mesh = get_mesh()
    if mesh is None:
        return None
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names) or None


def model_axis_size() -> int:
    mesh = get_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return 1
    return axis_size(mesh, "model")


def spec_placements(mesh, shape, spec):
    """``Shard``/``Replicate`` per mesh dim for a tensor of ``shape`` under
    ``spec``: "batch" -> the batch axes (dropped when the dim is not
    divisible), "model" -> the model axis (dropped when not divisible),
    None -> replicated. An axis of size 1 gives ``Replicate``, the same
    layout."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    bax = tuple(a for a in ("pod", "data") if a in names)
    for d, (dim, s) in enumerate(zip(shape, spec)):
        if s == "batch":
            n = 1
            for a in (bax or ()):
                n *= axis_size(mesh, a)
            if bax and dim % n == 0:
                for a in bax:
                    if axis_size(mesh, a) > 1:
                        out[names.index(a)] = Shard(d)
        elif s == "model":
            m = axis_size(mesh, "model") if "model" in names else 1
            if m > 1 and dim % m == 0:
                out[names.index("model")] = Shard(d)
    return out


def constrain(x, *spec):
    """Redistribute the ``DTensor`` ``x`` to the placements ``spec`` gives
    on the context mesh; a no-op without a mesh or on a plain tensor.
    ``spec`` entries: "batch" -> the batch axes (dropped when the dim is
    not divisible), "model" -> the model axis (dropped when not
    divisible), None -> replicated.

    Model code uses this where the layout of a large intermediate must
    be pinned (attention's inputs and the rglru gates); a ``Partial``
    placement is reduced here.
    """
    from torch.distributed.tensor import DTensor
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, spec_placements(mesh, x.shape, spec))


def batch_sharded(x):
    """``x`` pinned batch-sharded and replicated on every other dim, and
    its gradient pinned so too: the residual stream's layout at each
    sublayer's output. Eager DTensor would otherwise let it drift (a
    partial sum reduce-scattered over the hidden dim, the batch
    gathered), and let its gradient stay a partial sum over ``model``,
    which the next product's backward meets by gathering its weight whole
    (the full product on every model rank). GSPMD propagates the inputs'
    batch sharding and all-reduces there. A no-op without a mesh or on a
    plain tensor."""
    from torch.distributed.tensor import DTensor
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return _Pinned.apply(x, tuple(spec_placements(
        mesh, x.shape, ("batch",) + (None,) * (x.ndim - 1))))


class _Pinned(torch.autograd.Function):
    """Redistribute forward, and the gradient to the same placements
    backward."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def full(shape, value, dtype, device, *spec):
    """``torch.full(shape, value)``; under a mesh a ``DTensor`` placed by
    ``spec`` (as ``constrain`` reads it) whose shards are made locally,
    with no communication (the decode caches)."""
    mesh = get_mesh()
    if mesh is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor, Shard
    placements = spec_placements(mesh, shape, spec)
    local = list(shape)
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[md]
    t = torch.full(local, value, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def zeros(shape, dtype, device, *spec):
    return full(shape, 0, dtype, device, *spec)
