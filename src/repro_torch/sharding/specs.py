"""Partition specs (``repro.sharding.specs``) for params, optimizer state,
activations and caches, and the ``DTensor`` placements they give.

Layout policy (single pod mesh (16,16) axes ("data","model"); multi-pod
(2,16,16) axes ("pod","data","model")):

- 2-D weight sharding: feature-in ("fan-in") dims on ``data`` (FSDP/ZeRO-3),
  feature-out / heads / experts / vocab dims on ``model`` (tensor/expert
  parallel). Replicated across ``pod`` (pods are pure data parallel).
- Optimizer moments: identical specs to their params (fp32).
- Activations: batch on ("pod","data"), heads / hidden-parallel dims on
  ``model``. Batch=1 shapes (long_500k) replicate batch and let the data
  axis idle.
- KV caches: kv-head dim on ``model`` when divisible, else the cache
  sequence dim goes on ``model``.

A spec is a ``P``: a tuple with one entry per tensor dim, each None, an
axis name or a tuple of axis names, as ``jax.sharding.PartitionSpec``.
``placements(spec, mesh)`` turns it into one ``Shard``/``Replicate`` per
mesh dim. The rules are the JAX package's, keyed by the last dotted
component of a parameter's name. The port keeps one tensor per layer
(``layers.<i>.attn.wq``) where the JAX package stacks them, so the
reference's leading None for the stacked dim has no counterpart here.
``shard_model`` and ``shard_opt_state`` make the parameters and the AdamW
moments ``DTensor``s by these specs.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from repro_torch.config import HYBRID, ModelConfig
from repro_torch.sharding.context import axis_names, axis_size


class P(tuple):
    """A partition spec: one entry per tensor dim (a one-axis tuple is
    kept as its axis name, as ``PartitionSpec`` keeps it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _n_batch_shards(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def bspec(mesh, batch: int, *rest) -> P:
    """Batch-leading spec; replicates batch when not divisible."""
    ax = batch_axes(mesh)
    if batch % max(_n_batch_shards(mesh), 1) != 0:
        return P(None, *rest)
    return P(ax, *rest)


# ---------------------------------------------------------------------------
# Param specs: name-based rules applied to each parameter's trailing dims
# ---------------------------------------------------------------------------
_D, _M = "data", "model"

# trailing-dims spec per param name (applied to the last len(spec) dims)
_RULES = {
    # embeddings / head
    "embed": (_M, _D),
    "lm_head": (_D, _M),
    "enc_in": (_D, None),
    # attention
    "wq": (_D, _M, None),
    "wk": (_D, _M, None),
    "wv": (_D, _M, None),
    "wo": (_M, None, _D),
    "q_norm": (None,),
    "k_norm": (None,),
    # MLA
    "w_dq": (_D, None),
    "q_norm_lora": (None,),
    "w_dkv": (_D, None),
    "kv_norm": (None,),
    "w_uk": (_M, None, None),
    "w_uv": (_M, None, None),
    # mlp
    "w_gate": (_D, _M),
    "w_up": (_D, _M),
    "w_down": (_M, _D),
    # moe (must match the expert-parallel block's placements in
    # repro_torch.models.moe)
    "router": (None, None),
    "w1": (_M, _D, None),
    "w3": (_M, _D, None),
    "w2": (_M, None, _D),
    "sh_gate": (None, _M),
    "sh_up": (None, _M),
    "sh_down": (_M, None),
    # mamba2
    "w_z": (_D, _M),
    "w_x": (_D, _M),
    "w_B": (_D, None),
    "w_C": (_D, None),
    "w_dt": (_D, _M),
    "conv_x": (None, _M),
    "conv_B": (None, None),
    "conv_C": (None, None),
    "A_log": (_M,),
    "dt_bias": (_M,),
    "D_skip": (_M,),
    "out_norm": (_M,),
    "w_out": (_M, _D),
    # rg-lru
    "w_y": (_D, _M),
    "conv": (None, _M),
    "w_r": (None, _M),
    "w_i": (None, _M),
    "lam": (_M,),
    # norms
    "ln": (None,),
    "ln1": (None,),
    "ln2": (None,),
    "lnx": (None,),
    "final_norm": (None,),
    "enc_norm": (None,),
}


def _spec_for(name: str, shape, mesh) -> P:
    ndim = len(shape)
    rule = _RULES.get(name)
    if rule is None:
        rule = (None,) * ndim
    # pad leading dims with None
    lead = ndim - len(rule)
    full = (None,) * lead + tuple(rule)
    # drop axes absent from the mesh, and axes whose dim is not divisible
    # by the axis size (e.g. kv_heads=8 on a 16-way model axis -> replicate)
    names = axis_names(mesh)
    out = []
    for dim, ax in zip(shape, full):
        if ax is None or ax not in names or dim % axis_size(mesh, ax) != 0:
            out.append(None)
        else:
            out.append(ax)
    return P(*out)


def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _named(params) -> Dict[str, object]:
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, mesh) -> Dict[str, P]:
    """Parameter name -> spec, for a module (its ``named_parameters()``)
    or a name -> tensor mapping (a state dict)."""
    return {n: _spec_for(_leaf_name(n), tuple(t.shape), mesh)
            for n, t in _named(params).items()}


def opt_specs(opt_state, params_spec, zero_axis: str = None, params=None,
              mesh=None):
    """AdamW moments share their param's spec; step is replicated.

    zero_axis: additionally shard each moment's first unsharded divisible
    dim over this axis (ZeRO-style optimizer-state sharding, e.g. across
    pods). The JAX package's stacked leaves take it on the layer dim; a
    layer's tensor here takes it on its own first divisible dim, which
    halves the moments per device all the same."""
    from repro_torch.optim.adamw import AdamWState
    if zero_axis is None:
        return AdamWState(step=P(), mu=dict(params_spec),
                          nu=dict(params_spec))
    size = axis_size(mesh, zero_axis)
    shapes = {n: tuple(t.shape) for n, t in _named(params).items()}

    def widen(spec, shape):
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (ax, dim) in enumerate(zip(entries, shape)):
            if ax is None and dim % size == 0:
                entries[i] = zero_axis
                break
        return P(*entries)

    mspec = {n: widen(s, shapes[n]) for n, s in params_spec.items()}
    return AdamWState(step=P(), mu=mspec, nu=dict(mspec))


# ---------------------------------------------------------------------------
# Activation / cache specs
# ---------------------------------------------------------------------------
def token_spec(mesh, batch: int) -> P:
    return bspec(mesh, batch, None)


def embeds_spec(mesh, batch: int) -> P:
    return bspec(mesh, batch, None, None)


def logits_spec(mesh, batch: int, vocab: int = 0) -> P:
    m = _M if _M in axis_names(mesh) else None
    if m is not None and vocab and vocab % axis_size(mesh, _M) != 0:
        m = None              # e.g. seamless vocab 256206 on a 16-way axis
    return bspec(mesh, batch, None, m)


def _kv_dims(cfg: ModelConfig, mesh) -> Tuple[Optional[str], Optional[str]]:
    """(seq_dim_axis, kv_head_axis) for a KV cache."""
    if _M not in axis_names(mesh):
        return None, None
    msize = axis_size(mesh, _M)
    if cfg.num_kv_heads and cfg.num_kv_heads % msize == 0:
        return None, _M
    return _M, None


def cache_specs(cfg: ModelConfig, caches, mesh, batch: int):
    """Specs for the decode caches ``init_decode_caches`` returns: one per
    layer, each the cache's own NamedTuple of specs."""
    from repro_torch.models.attention import KVCache, MLACache
    from repro_torch.models.encdec import DecCache
    from repro_torch.models.mamba2 import SSMCache
    from repro_torch.models.rglru import RecCache
    bax = batch_axes(mesh) if batch % max(_n_batch_shards(mesh), 1) == 0 \
        else None
    seq_ax, kvh_ax = _kv_dims(cfg, mesh)
    m = _M if _M in axis_names(mesh) else None

    def kv_spec():
        return KVCache(k=P(bax, seq_ax, kvh_ax, None),
                       v=P(bax, seq_ax, kvh_ax, None), pos=P(None))

    def one(cache):
        if isinstance(cache, KVCache):
            return kv_spec()
        if isinstance(cache, MLACache):
            return MLACache(c=P(bax, m, None), kr=P(bax, m, None),
                            pos=P(None))
        if isinstance(cache, SSMCache):
            return SSMCache(state=P(bax, m, None, None),
                            conv_x=P(bax, None, m),
                            conv_B=P(bax, None, None),
                            conv_C=P(bax, None, None))
        if isinstance(cache, DecCache):
            return DecCache(self_kv=kv_spec(),
                            cross_k=P(bax, None, kvh_ax, None),
                            cross_v=P(bax, None, kvh_ax, None))
        if isinstance(cache, RecCache) and cfg.family == HYBRID:
            return RecCache(h=P(bax, m), conv=P(bax, None, m))
        raise TypeError(type(cache))

    return [one(c) for c in caches]


# ---------------------------------------------------------------------------
# Placements and sharded state
# ---------------------------------------------------------------------------
def placements(spec, mesh):
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dim for ``spec``. A
    tensor dim over several mesh axes (("pod", "data")) is split in mesh
    order, the first axis outermost, as in JAX. An axis of size 1 gives
    ``Replicate`` (the same layout; DTensor's view rules refuse to merge
    a dim sharded over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


def distribute(t, mesh, spec):
    """A ``DTensor`` of ``t`` placed by ``spec``. Every rank holds the whole
    of ``t`` (the same seed, or the bridged weights), so each keeps its
    own shard and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                             src_data_rank=None)


def shard_model(model, mesh, p_spec: Optional[Mapping[str, P]] = None):
    """Replace every plain parameter of ``model`` with a ``DTensor`` placed
    by ``param_specs`` (or ``p_spec``), in place; keeps ``requires_grad``.
    A parameter that is a ``DTensor`` already stays as it is. Returns the
    model."""
    from torch import nn
    from torch.distributed.tensor import DTensor
    p_spec = p_spec or param_specs(model, mesh)
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(
            distribute(p, mesh, p_spec[name]), requires_grad=p.requires_grad)
    return model


def shard_opt_state(opt_state, mesh, o_spec):
    """The AdamW state with its moments made ``DTensor``s placed by
    ``o_spec`` (``opt_specs``; moments that are ``DTensor``s already are
    redistributed where their placements differ); the step stays a
    plain 0-d tensor, the same on every rank."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=opt_state.step,
                      mu=place(opt_state.mu, mesh, o_spec.mu),
                      nu=place(opt_state.nu, mesh, o_spec.nu))


def place(tree, mesh, spec_tree):
    """A tensor, or a (nested) dict / tuple / NamedTuple / list of them, made
    ``DTensor``s by the matching specs; a ``DTensor`` is redistributed.
    Non-tensor leaves pass through."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        want = placements(spec_tree, mesh)
        if list(tree.placements) == want:
            return tree
        return tree.redistribute(mesh, want)
    if isinstance(tree, torch.Tensor):
        return distribute(tree, mesh, spec_tree)
    if isinstance(tree, dict):
        return {k: place(v, mesh, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(spec_tree, P):
        items = [place(t, mesh, s) for t, s in zip(tree, spec_tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def unshard(tree):
    """``place``'s inverse: every ``DTensor`` in a (nested) dict / tuple /
    list made its whole plain tensor (``full_tensor``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: unshard(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [unshard(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def unshard_model(model):
    """Replace every ``DTensor`` parameter of ``model`` with a plain one
    holding its whole tensor, in place; keeps ``requires_grad``."""
    from torch import nn
    from torch.distributed.tensor import DTensor
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            mod._parameters[leaf] = nn.Parameter(
                p.detach().full_tensor(), requires_grad=p.requires_grad)
    return model
