"""The kernel wrappers under a mesh: a ``DTensor`` argument is unwrapped
to its local shard, the kernel (or the plain version) runs on the shard,
and the result is wrapped back with the placements the op implies.

Nothing goes through a ``DTensor``'s ``data_ptr()``: ``to_local`` and
``from_local`` are differentiable, so the backward kernels run on the
shards too. A placement a kernel cannot take raises, naming it; nothing
falls back to a gather the caller did not ask for, except the decode
cache's sequence dim, which ``gather_dims`` gathers by design.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def is_sharded(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def _name(p) -> str:
    return f"{type(p).__name__}({getattr(p, 'dim', '')})"


def check(op: str, x: DTensor, allowed, what: str) -> None:
    """Raise unless every placement of ``x`` is ``Replicate`` or a
    ``Shard`` of a dim in ``allowed``."""
    for md, p in enumerate(x.placements):
        if isinstance(p, Replicate):
            continue
        if isinstance(p, Shard) and p.dim in allowed:
            continue
        raise NotImplementedError(
            f"{op}: {what} placed {_name(p)} on mesh dim {md} "
            f"({x.device_mesh.mesh_dim_names[md]}); it takes Shard of "
            f"dims {sorted(allowed)} or Replicate")


def same(op: str, a: DTensor, b: DTensor, what: str) -> None:
    if a.device_mesh != b.device_mesh or \
            tuple(a.placements) != tuple(b.placements):
        raise NotImplementedError(
            f"{op}: {what} placed {[_name(p) for p in b.placements]}, "
            f"unlike {[_name(p) for p in a.placements]}")


def gather_dims(x: DTensor, dims) -> DTensor:
    """``x`` with every ``Shard`` of a dim in ``dims`` all-gathered."""
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def local_offset(x: DTensor, dim: int):
    """(offset, length) of this rank's shard of ``x`` along ``dim``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def kv_heads_for(op: str, q: DTensor, k: DTensor, v: DTensor, hdim: int):
    """Local q, k and v shards (head dim ``hdim``) for a grouped-query
    kernel, which reads local query head i against local kv head
    i // (H_local / Kh_local). Per mesh dim: q and k share a batch
    ``Shard(0)``; heads may be sharded on both (H and Kh divisible, as
    today) or on q alone (k and v replicated on that dim: Kh does not
    divide the axis). Then this rank's query heads [o, o + H_local) use
    the global kv heads [o // G, (o + H_local - 1) // G], G = H / Kh,
    which are sliced out where the local heads cover whole groups or lie
    in one group (H_local and G divide one another); other head counts
    raise. The kv gradient of such a dim is then a partial sum over its
    ranks."""
    same(op, k, v, "v")
    mesh = q.device_mesh
    grad_pl = []
    for md, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        ax = mesh.mesh_dim_names[md]
        if isinstance(pq, Shard) and pq.dim == hdim and \
                isinstance(pk, Replicate):
            grad_pl.append(Partial())
            continue
        if pq != pk:
            raise NotImplementedError(
                f"{op}: q placed {_name(pq)} and k {_name(pk)} on mesh dim "
                f"{md} ({ax})")
        grad_pl.append(pk)
    H, Kh = q.shape[hdim], k.shape[hdim]
    G = H // Kh
    q_off, Hl = local_offset(q, hdim)
    k_off, Khl = local_offset(k, hdim)
    lo, hi = q_off // G, (q_off + Hl - 1) // G
    if lo < k_off or hi >= k_off + Khl:
        raise NotImplementedError(
            f"{op}: query heads [{q_off}, {q_off + Hl}) need kv heads "
            f"[{lo}, {hi}], not on this rank's [{k_off}, {k_off + Khl})")
    ql = q.to_local()
    kl = k.to_local(grad_placements=grad_pl)
    vl = v.to_local(grad_placements=grad_pl)
    if Khl == hi - lo + 1 and k_off == lo:
        return ql, kl, vl
    if Hl % G and G % Hl:
        raise NotImplementedError(
            f"{op}: {Hl} of {H} query heads per rank against {Kh} kv heads "
            f"(groups of {G}): the local heads neither cover whole groups "
            f"nor lie in one")
    idx = (slice(None),) * hdim + (slice(lo - k_off, hi - k_off + 1),)
    return ql, kl[idx], vl[idx]


def wrap(out: torch.Tensor, like: DTensor) -> DTensor:
    """``out``, a local shard laid out as ``like``'s, as a ``DTensor`` with
    ``like``'s mesh and placements."""
    return DTensor.from_local(out, like.device_mesh, like.placements,
                              run_check=False)
