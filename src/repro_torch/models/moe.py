"""Mixture-of-Experts decoder LM (llama4-scout: 16 experts top-1 + a shared
expert + chunked attention; deepseek-v2: 160 experts top-6 + 2 shared
experts + MLA): ``repro.models.moe`` as PyTorch modules, on one device.

The MoE block is the JAX package's single-device branch (no mesh), op for
op: router logits in fp32, softmax, the k largest gates (the lower
expert first on a tie, as ``jax.lax.top_k``), renormalised; a sort-based,
capacity-bounded dispatch (the stable argsort of the expert ids decides
which entries past an expert's capacity C are dropped); the experts'
products; the inverse permutation, the gate-weighted sum over k; and the
Switch load-balance aux loss. The dispatch is jnp in the JAX package, so
it runs on torch ops here.

The experts' products take one of two paths, picked by whether autograd
records, never by a switch. Where it records (the train steps), they are
the JAX package's: the kept entries scattered into an [E * C + 1, D]
buffer whose last row takes the dropped ones (every kept entry has its
own row and the dropped ones add zeros to the last, so the buffer's bits
do not depend on the order of the adds), and batched products over every
expert's C rows. Where it does not (every served forward), the kept
entries, in the dispatch's expert order, go through a grouped product
(``kernels.moe_gemm``: a kernel on the card, its plain loop on the CPU)
over each expert's min(count, C) rows, the groups' offsets a scan on the
device, so nothing syncs the host and a captured layer is right for any
routing. At dropless capacity (C = T) the padded path computes E / k
times the routed work; the grouped one only that work. The kept set, the
gates and the sum over k are the same on both. The served path also adds
the entries routed to each expert and those dropped to the module's
device-side counters (``spans.count_moe``).

Under a mesh (a step's ``mesh_context``, its tensors ``DTensor``s) the
JAX package's branches are kept, with its condition: with a model axis
of size ep > 1 and at least ep experts, the expert-parallel block runs on
each rank (the JAX package's ``shard_map``, here ``to_local`` /
``from_local`` around the same per-rank block): every rank routes its
batch shard's tokens (all of them where B does not divide the batch
shards) to its E / ep experts from expert ``ei * E / ep`` on, with the
FSDP all-gathers of w1 / w3 (dim 1) and w2 (dim 2) over ``data`` as
redistributions, the shared expert on its ``Fs / ep`` column slice, the
partial outputs summed over ``model``, and the aux averaged over the
batch shards (each shard's own aux, so not the un-meshed aux). Otherwise
the single-device block runs on every rank over all tokens and whole
weights, as GSPMD computes it: the tokens and weights are replicated
first.

Layers are grouped by the chunk pattern (llama4: three chunked layers,
then one full); under ``cfg.remat`` each group is checkpointed when
autograd records, as the JAX package's ``_grouped_scan`` checkpoints its
body. Parameters keep the JAX names and shapes (``layers.<i>.moe.w1`` ...,
``repro_torch.bridge``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import spans
from repro_torch.config import MOE, ModelConfig
from repro_torch.kernels.moe_gemm.ops import moe_grouped_ffn
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Maker, remat, rms_norm, torch_dtype
from repro_torch.sharding import context as shctx


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
class MoEFFN(nn.Module):
    """The JAX package's ``moe_ffn_build``: router [D, E] (scale 0.1),
    w1, w3 [E, D, F], w2 [E, F, D]; the shared expert's sh_gate, sh_up
    [D, Fs], sh_down [Fs, D] with Fs = F * num_shared_experts."""

    def __init__(self, make: Maker, cfg: ModelConfig, prefix: str = ""):
        super().__init__()
        D, E = cfg.d_model, cfg.num_experts
        Fe = cfg.resolved_moe_d_ff
        #: (model, layer) under which ``spans`` counts this layer's routing
        self.count_name = (cfg.name, prefix.rstrip("."))
        self.router = make(prefix + "router", (D, E), scale=0.1)
        self.w1 = make(prefix + "w1", (E, D, Fe))           # gate proj
        self.w3 = make(prefix + "w3", (E, D, Fe))           # up proj
        self.w2 = make(prefix + "w2", (E, Fe, D))           # down proj
        if cfg.num_shared_experts:
            Fs = Fe * cfg.num_shared_experts
            self.sh_gate = make(prefix + "sh_gate", (D, Fs))
            self.sh_up = make(prefix + "sh_up", (D, Fs))
            self.sh_down = make(prefix + "sh_down", (Fs, D))


class MoELayer(nn.Module):
    """ln1, attn (GQA, or MLA under ``cfg.use_mla``), ln2, moe."""

    def __init__(self, make: Maker, cfg: ModelConfig, prefix: str = ""):
        super().__init__()
        D = cfg.d_model
        self.ln1 = make(prefix + "ln1", (D,), "zeros")
        self.attn = tfm.attn_build(make, cfg, prefix=prefix + "attn.")
        self.ln2 = make(prefix + "ln2", (D,), "zeros")
        self.moe = MoEFFN(make, cfg, prefix=prefix + "moe.")


def layer_build(make: Maker, cfg: ModelConfig, index: int) -> MoELayer:
    return MoELayer(make, cfg, prefix=f"layers.{index}.")


class MoEModel(nn.Module):
    """embed [V, D], layers.<i> (MoELayer), final_norm [D], lm_head
    [D, V] (absent with tied embeddings)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family != MOE:
            raise ValueError(f"{cfg.name} is not an MoE model")
        self.cfg = cfg
        make = Maker(seed, torch_dtype(cfg.dtype), device)
        self.embed = make("embed", (cfg.vocab_size, cfg.d_model), "embed")
        self.layers = nn.ModuleList(layer_build(make, cfg, i)
                                    for i in range(cfg.num_layers))
        self.final_norm = make("final_norm", (cfg.d_model,), "zeros")
        if not cfg.tie_embeddings:
            self.lm_head = make("lm_head", (cfg.d_model, cfg.vocab_size))

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> MoEModel:
    """Random weights from ``seed``, made on ``device``."""
    return MoEModel(cfg, seed, device)


# ---------------------------------------------------------------------------
# Routing + capacity dispatch
# ---------------------------------------------------------------------------
def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(cfg.capacity_factor * num_tokens * cfg.top_k
                      / max(cfg.num_experts, 1)))
    c = max(c, 8)
    return min(-(-c // 8) * 8, num_tokens * cfg.top_k)


def _route(x2, p: MoEFFN, cfg: ModelConfig):
    """(probs [T, E] fp32, renormalised gates [T, k], expert ids [T, k])."""
    logits = x2.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    # the k largest, the lower expert first on a tie (jax.lax.top_k's
    # order, which torch.topk does not promise)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, gates, idx


def _dispatch(idx, C: int, e_local: int):
    """The sort-based dispatch of the T * k entries (token-major) to the
    local experts 0 .. e_local - 1 (``idx`` counted from this rank's first
    expert): their order sorted stably by local expert (other ranks'
    entries last), each entry's buffer row (local expert * C + its place
    in the expert's group, or the trash row e_local * C past capacity or
    for another rank's expert) and whether it is kept, all in sorted
    order."""
    local_e = idx.reshape(-1)
    is_local = (local_e >= 0) & (local_e < e_local)
    sort_key = torch.where(is_local, local_e, e_local)    # non-local -> end
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    n = torch.arange(sort_key.numel(), device=idx.device)
    pos_in_grp = n - torch.searchsorted(sorted_e, sorted_e, side="left")
    keep = (sorted_e < e_local) & (pos_in_grp < C)
    dest = torch.where(keep, sorted_e * C + pos_in_grp, e_local * C)
    return order, dest, keep


def _moe_ffn_block(x2, p: MoEFFN, cfg: ModelConfig, e_start: int = 0,
                   e_local: int = 0, w1=None, w3=None, w2=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contribution of experts [e_start, e_start + e_local) (all of them
    by default) to tokens x2 [T, D], with expert weights w1, w3, w2 (the
    parameters by default). Returns (y [T, D], the aux loss as an fp32
    scalar; the aux is over all experts, the same on every rank)."""
    T, D = x2.shape
    E, k = cfg.num_experts, cfg.top_k
    e_local = e_local or E
    w1 = p.w1 if w1 is None else w1
    w3 = p.w3 if w3 is None else w3
    w2 = p.w2 if w2 is None else w2
    probs, gates, idx = _route(x2, p, cfg)
    C = _capacity(T, cfg)
    order, dest, keep = _dispatch(idx - e_start, C, e_local)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x2, w1, w3, w2)):
        contrib = _padded_experts(x2, order, dest, keep, C, e_local, k,
                                  w1, w3, w2)
    else:
        contrib = _grouped_experts(x2, p, idx - e_start, order, keep, C,
                                   e_local, k, w1, w3, w2)
    y = (contrib * gates.reshape(-1, 1).to(contrib.dtype)
         ).reshape(T, k, D).sum(dim=1)

    # Switch-style load-balance aux loss over all experts
    me = probs.mean(dim=0)                                 # [E]
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    aux = E * torch.sum(me * ce) * (1.0 / k)
    return y, aux


def _inverse(order):
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv


def _padded_experts(x2, order, dest, keep, C: int, e_local: int, k: int,
                    w1, w3, w2):
    """Every expert over its C buffer rows (the JAX package's products);
    returns each entry's expert output, token-major [T * k, D], zero where
    dropped."""
    D = x2.shape[1]
    flat_t = torch.div(order, k, rounding_mode="floor")    # token of each
    gathered = torch.where(keep[:, None], x2[flat_t], 0)
    buf = x2.new_zeros((e_local * C + 1, D)).index_add(0, dest, gathered)
    buf = buf[:e_local * C].reshape(e_local, C, D)

    h = F.silu(torch.bmm(buf, w1).float()).to(x2.dtype)
    h = h * torch.bmm(buf, w3)
    out = torch.bmm(h, w2).reshape(e_local * C, D)
    out = torch.cat([out, out.new_zeros((1, D))], dim=0)

    contrib_sorted = out[dest] * keep[:, None].to(out.dtype)
    return contrib_sorted[_inverse(order)]


def _grouped_experts(x2, p, local_idx, order, keep, C: int, e_local: int,
                     k: int, w1, w3, w2):
    """The kept entries through the grouped product: expert e's group is
    the first min(count_e, C) of its entries in the dispatch's order,
    packed from offsets[e] (a scan of the group sizes on the device).
    Returns each entry's expert output, token-major [T * k, D], zero where
    dropped."""
    N = order.numel()
    dev = order.device
    flat_e = local_idx.reshape(-1)
    sorted_e = torch.where((flat_e >= 0) & (flat_e < e_local), flat_e,
                           e_local)[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e_local + 1,
                                                       device=dev))
    counts = starts.diff()
    sizes = counts.clamp(max=C)
    offsets = torch.cat([sizes.new_zeros(1), sizes.cumsum(0)])
    # each sorted entry's row in the packed groups (N past the kept ones)
    pos = torch.arange(N, device=dev) - starts[sorted_e]
    row = torch.where(keep, offsets[sorted_e] + pos, N)
    src = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    src[row] = torch.div(order, k, rounding_mode="floor")
    out = moe_grouped_ffn(x2, src[:N], offsets.to(torch.int32), w1, w3, w2)
    if isinstance(p, MoEFFN) and dev.type != "meta":
        spans.count_moe(p, p.count_name, counts, (counts - sizes).sum())
    inv = _inverse(order)
    return torch.where(keep[inv][:, None], out[row.clamp(max=N - 1)[inv]],
                       0)


def _shared_expert(x2, sh_gate, sh_up, sh_down):
    """The shared experts' MLP (on a column slice of their hidden dim
    under expert parallelism)."""
    g = x2 @ sh_gate
    u = x2 @ sh_up
    h = F.silu(g.float()).to(x2.dtype) * u
    return h @ sh_down


def moe_apply(p: MoEFFN, x, cfg: ModelConfig):
    """x: [B, S, D] -> (y [B, S, D], aux scalar): the JAX package's
    ``moe_apply``."""
    B, S, D = x.shape
    mesh = shctx.get_mesh()
    ep = shctx.model_axis_size()
    if mesh is None or ep == 1 or cfg.num_experts < ep:
        if mesh is not None and _sharded(x):
            return _replicated_block(p, x, cfg, mesh)
        x2 = x.reshape(B * S, D)
        y, aux = _moe_ffn_block(x2, p, cfg)
        if cfg.num_shared_experts:
            y = y + _shared_expert(x2, p.sh_gate, p.sh_up, p.sh_down)
        return y.reshape(B, S, D), aux
    return _expert_parallel_block(p, x, cfg, mesh, ep)


def _sharded(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _weights(p: MoEFFN, cfg: ModelConfig):
    names = ["router", "w1", "w3", "w2"]
    if cfg.num_shared_experts:
        names += ["sh_gate", "sh_up", "sh_down"]
    return {n: getattr(p, n) for n in names}


def _replicated_block(p: MoEFFN, x, cfg: ModelConfig, mesh):
    """The single-device block under a mesh: tokens and weights
    replicated, the block run whole on every rank (so every gradient is
    whole on every rank), the output replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    B, S, D = x.shape
    xl = x.redistribute(mesh, rep).to_local()
    w = {n: t.redistribute(mesh, rep).to_local()
         for n, t in _weights(p, cfg).items()}
    x2 = xl.reshape(B * S, D)
    y, aux = _moe_ffn_block(x2, _Local(w), cfg)
    if cfg.num_shared_experts:
        y = y + _shared_expert(x2, w["sh_gate"], w["sh_up"], w["sh_down"])
    return (DTensor.from_local(y.reshape(B, S, D), mesh, rep,
                               run_check=False),
            DTensor.from_local(aux, mesh, rep, run_check=False))


class _Local:
    """Local shards of an ``MoEFFN``'s weights, read as its attributes."""

    def __init__(self, w):
        self.__dict__.update(w)


def _expert_parallel_block(p: MoEFFN, x, cfg: ModelConfig, mesh, ep: int):
    """The JAX package's ``shard_map`` block, per rank. Placements in
    (and, for the backward, of the local gradients): tokens [B, S, D]
    batch-sharded (replicated where B does not divide the batch shards)
    and replicated over ``model``, their gradient a partial sum over
    ``model``; the router replicated; w1, w3 [E, D, F] and w2 [E, F, D]
    expert-sharded over ``model`` and gathered over ``data``; the shared
    expert's columns (rows of sh_down) over ``model``. A weight's local
    gradient is a partial sum over the batch axes that shard the tokens.
    Out: y, a partial sum over ``model``, summed; and the aux, a partial
    sum over ``model`` and the batch axes of aux / (ep * shards), so that
    its sum is the mean over the batch shards and its gradient reaches
    the router once."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    names = shctx.axis_names(mesh)
    baxes = shctx.batch_axes()
    B, S, D = x.shape
    nb = 1
    for a in (baxes or ()):
        nb *= shctx.axis_size(mesh, a)
    if baxes and B % nb != 0:
        baxes = None          # tiny/unshardable batch: replicate tokens
    bdims = [names.index(a) for a in (baxes or ())]
    mdim = names.index("model")
    nshards = nb if baxes else 1
    E_loc = cfg.num_experts // ep

    def pl(model=None, batch=None):
        """Placements: ``model`` on the model dim, ``batch`` on the batch
        dims, Replicate elsewhere."""
        out = [Replicate()] * mesh.ndim
        if model is not None:
            out[mdim] = model
        for d in bdims:
            if batch is not None:
                out[d] = batch
        return out

    part = Partial() if baxes else None       # grads over the batch dims
    x_in = pl(batch=Shard(0) if baxes else None)
    x_grad = pl(model=Partial(), batch=Shard(0) if baxes else None)
    xl = x.redistribute(mesh, x_in).to_local(grad_placements=x_grad)
    w = {"router": (pl(), pl(model=Partial(), batch=part)),
         "w1": (pl(model=Shard(0)), pl(model=Shard(0), batch=part)),
         "w3": (pl(model=Shard(0)), pl(model=Shard(0), batch=part)),
         "w2": (pl(model=Shard(0)), pl(model=Shard(0), batch=part))}
    if cfg.num_shared_experts:
        w["sh_gate"] = (pl(model=Shard(1)), pl(model=Shard(1), batch=part))
        w["sh_up"] = (pl(model=Shard(1)), pl(model=Shard(1), batch=part))
        w["sh_down"] = (pl(model=Shard(0)), pl(model=Shard(0), batch=part))
    tensors = _weights(p, cfg)
    loc = {n: tensors[n].redistribute(mesh, into).to_local(
        grad_placements=grad) for n, (into, grad) in w.items()}
    ei = mesh.get_local_rank("model")

    T_loc = xl.shape[0] * xl.shape[1]
    x2 = xl.reshape(T_loc, D)
    y, aux = _moe_ffn_block(x2, _Local(loc), cfg, ei * E_loc, E_loc,
                            loc["w1"], loc["w3"], loc["w2"])
    if cfg.num_shared_experts:
        y = y + _shared_expert(x2, loc["sh_gate"], loc["sh_up"],
                               loc["sh_down"])
    y = DTensor.from_local(y.reshape(xl.shape), mesh,
                           pl(model=Partial(),
                              batch=Shard(0) if baxes else None),
                           run_check=False)
    y = y.redistribute(mesh, pl(batch=Shard(0) if baxes else None))
    aux = DTensor.from_local(aux / (ep * nshards), mesh,
                             pl(model=Partial(), batch=part),
                             run_check=False)
    return y, aux.redistribute(mesh, pl())


# ---------------------------------------------------------------------------
# Layers + model
# ---------------------------------------------------------------------------
def layer_kinds(cfg: ModelConfig) -> List[Tuple[Optional[int],
                                                Optional[int]]]:
    """(window, chunk) per layer. llama4: 3-of-4 chunked, every 4th
    full."""
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.chunk_pattern and (i + 1) % cfg.chunk_pattern == 0:
            kinds.append((cfg.sliding_window, None))       # full/NoPE layer
        else:
            kinds.append((cfg.sliding_window, cfg.attention_chunk))
    return kinds


def layer_apply(lp: MoELayer, x, positions, cfg: ModelConfig, *, window,
                chunk):
    """One layer over x [B, S, D] -> (x, aux)."""
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + tfm.attn_apply_full(lp.attn, h, positions, cfg, window=window,
                                chunk=chunk)
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    y, aux = moe_apply(lp.moe, h, cfg)
    return x + y, aux


def _groups(cfg: ModelConfig) -> List[range]:
    """The layer indices of each chunk-pattern group."""
    L, pat = cfg.num_layers, cfg.chunk_pattern or 1
    assert L % pat == 0, (L, pat)
    return [range(g, g + pat) for g in range(0, L, pat)]


def forward(model: MoEModel, tokens, cfg: ModelConfig, extra_embeds=None):
    """tokens: [B, S] -> (logits [B, S, V], aux summed over layers). Each
    chunk-pattern group is checkpointed under ``cfg.remat`` when autograd
    records."""
    x = tfm.embed_tokens(model, tokens, cfg, extra_embeds)
    positions = tfm.positions_for(x)
    kinds = layer_kinds(cfg)

    def group(idx, x, *lps):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in zip(idx, lps):
            window, chunk = kinds[i]
            x, a = layer_apply(lp, x, positions, cfg, window=window,
                               chunk=chunk)
            aux = aux + a
        return x, aux

    auxes = []
    for idx in _groups(cfg):
        x, aux = remat(cfg, group, idx, x, *(model.layers[i] for i in idx))
        auxes.append(aux)
    return tfm.unembed(model, x, cfg), torch.stack(auxes).sum()


def prefill(model: MoEModel, tokens, cfg: ModelConfig, extra_embeds=None,
            extra_capacity: int = 0):
    """Returns (last-position logits [B, 1, V], one cache per layer).
    Every layer's ring has the capacity ``cache_capacity(S +
    extra_capacity, window, chunk)``, as in the JAX package: past the
    chunk (8192 positions for llama4) the full-attention layers, too,
    keep and decode over the last ``chunk`` positions only, where
    ``forward`` attends over all of them."""
    x = tfm.embed_tokens(model, tokens, cfg, extra_embeds)
    positions = tfm.positions_for(x)
    capacity = attn.cache_capacity(x.shape[1] + extra_capacity,
                                   cfg.sliding_window, cfg.attention_chunk)
    caches = []
    for lp, (window, chunk) in zip(model.layers, layer_kinds(cfg)):
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        y, cache = tfm.attn_prefill(lp.attn, h, positions, cfg, capacity,
                                    window=window, chunk=chunk)
        x = x + y
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        y, _ = moe_apply(lp.moe, h, cfg)
        x = x + y
        caches.append(cache)
    return tfm.unembed(model, x[:, -1:, :], cfg), caches


def decode_step(model: MoEModel, token, pos: int, caches, cfg: ModelConfig):
    """token: [B, 1] int32 at position ``pos`` (a host int); caches: one
    per layer, updated in place. -> (logits [B, 1, V], caches)."""
    x = tfm.embed_tokens(model, token, cfg)
    new_caches = []
    for lp, cache, (window, chunk) in zip(model.layers, caches,
                                          layer_kinds(cfg)):
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        y, cache = tfm.attn_apply_decode(lp.attn, h, cache, pos, cfg,
                                         window=window, chunk=chunk)
        x = x + y
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        y, _ = moe_apply(lp.moe, h, cfg)
        x = x + y
        new_caches.append(cache)
    return tfm.unembed(model, x, cfg), new_caches


init_decode_caches = tfm.init_decode_caches
