"""Dense decoder-only transformer LM (GQA / MQA / qk_norm / partial rotary /
sliding-window / chunked attention): ``repro.models.transformer`` as
PyTorch modules, with full-sequence forward, prefill and one-token decode.
Also provides the attention sublayer the hybrid, the encoder-decoder and
the MoE family use (MLA for deepseek-v2), and the decoder that the VLM
runs over its patches and tokens.

Parameters keep the JAX shapes and names (``wq`` [D, H, Dh], ``wo``
[H, Dh, D], ...), and the state-dict key of a parameter is its JAX tree
path with the layer stack split into ``layers.<i>``, so the weight bridge
(``repro_torch.bridge``) is a plain copy.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import DENSE, VLM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Maker, apply_rope, mlp_apply,
                                       remat, rms_norm, torch_dtype)
from repro_torch.sharding.context import (batch_sharded, constrain,
                                          model_axis_size)


# ---------------------------------------------------------------------------
# Attention sublayer
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, make: Maker, cfg: ModelConfig, prefix: str = ""):
        super().__init__()
        D, H, Kh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        Dh = cfg.resolved_head_dim
        self.wq = make(prefix + "wq", (D, H, Dh))
        self.wk = make(prefix + "wk", (D, Kh, Dh))
        self.wv = make(prefix + "wv", (D, Kh, Dh))
        self.wo = make(prefix + "wo", (H, Dh, D))
        if cfg.qk_norm:
            self.q_norm = make(prefix + "q_norm", (Dh,), "zeros")
            self.k_norm = make(prefix + "k_norm", (Dh,), "zeros")


class MLAttention(nn.Module):
    """MLA (deepseek-v2): wq [D, H, Dh + Dr] (or [rq, H, Dh + Dr] after
    w_dq [D, rq] and q_norm_lora [rq] when ``q_lora_rank``), w_dkv
    [D, r + Dr], kv_norm [r], w_uk [H, Dh, r], w_uv [H, r, dv], wo
    [H, dv, D] (the JAX shapes)."""

    def __init__(self, make: Maker, cfg: ModelConfig, prefix: str = ""):
        super().__init__()
        D, H, Dh = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        r, Dr, dv = (cfg.kv_lora_rank, cfg.rope_head_dim,
                     cfg.resolved_v_head_dim)
        rq = cfg.q_lora_rank
        self.wq = make(prefix + "wq", (rq or D, H, Dh + Dr))
        self.w_dkv = make(prefix + "w_dkv", (D, r + Dr))
        self.kv_norm = make(prefix + "kv_norm", (r,), "zeros")
        self.w_uk = make(prefix + "w_uk", (H, Dh, r))
        self.w_uv = make(prefix + "w_uv", (H, r, dv))
        self.wo = make(prefix + "wo", (H, dv, D))
        if rq:
            self.w_dq = make(prefix + "w_dq", (D, rq))
            self.q_norm_lora = make(prefix + "q_norm_lora", (rq,), "zeros")


def attn_build(make: Maker, cfg: ModelConfig, prefix: str = ""):
    if cfg.use_mla:
        return MLAttention(make, cfg, prefix)
    return Attention(make, cfg, prefix)


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", h, w) as one matrix product. (A reshape,
    not ``unflatten``: a DTensor under ``inference_mode`` checks
    ``unflatten``'s sizes against its local shard.)"""
    wf = w.reshape(w.shape[0], -1)
    if w.shape[1] % model_axis_size() == 0:
        out = h @ wf
        # under a mesh: the heads on the model axis (the flat columns
        # split between heads)
        out = constrain(out, "batch", *(None,) * (out.ndim - 2), "model")
    else:
        out = _replicated_product(h, wf)
    return out.reshape(*out.shape[:-1], *w.shape[1:])


def _replicated_product(h, wf):
    """h @ wf replicated over the model axis, for heads that do not
    divide it (a kv projection at Kh < the axis, llama4's 40 heads on 16):
    the weight gathered whole, the product run on each rank's batch rows.
    DTensor's own product would split the flat head columns (or, in the
    output projection's backward, the flat head rows) over the model
    axis, which the reshape to heads cannot take. The weight's local
    gradient is a partial sum over the batch shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = h.device_mesh
    hp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in h.placements]
    wg = [Partial() if isinstance(p, Shard) else Replicate() for p in hp]
    hl = h.redistribute(mesh, hp).to_local()
    wl = wf.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=wg)
    return DTensor.from_local(hl @ wl, mesh, hp, run_check=False)


def _qkv(p: Attention, h, positions, cfg: ModelConfig):
    q = _project(h, p.wq)
    k = _project(h, p.wk)
    v = _project(h, p.wv)
    if cfg.qk_norm:                       # per-head norm, before rope
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rotary_pct, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rotary_pct, cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, out):
    """einsum("bshk,hkd->bsd", out, wo)."""
    B, S = out.shape[:2]
    flat, wo = out.reshape(B, S, -1), p.wo.reshape(-1, p.wo.shape[-1])
    if p.wo.shape[0] % model_axis_size() == 0:
        return batch_sharded(flat @ wo)
    return batch_sharded(_replicated_product(flat, wo))


def attn_apply_full(p: Attention, h, positions, cfg: ModelConfig, *,
                    window: Optional[int] = None,
                    chunk: Optional[int] = None, causal: bool = True,
                    kv=None, return_kv: bool = False):
    """Full-sequence self-attention sublayer (causal unless ``causal`` is
    false), or cross-attention with ``kv=(k, v, kpos)``: then q alone is
    projected and q-normed, not roped, and k [B, Sk, Kh, Dh] and v are
    used as given. With ``return_kv`` also its k and v (for the decode
    cache). MLA attends causally with no window or chunk, and returns its
    latent and rope key (c, kr) for the cache."""
    if cfg.use_mla:
        return _mla_apply_full(p, h, positions, cfg, return_kv=return_kv)
    if kv is None:
        q, k, v = _qkv(p, h, positions, cfg)
        kpos = positions
    else:
        q = _project(h, p.wq)
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k, v, kpos = kv
    out = attn.attend(q, k, v, positions, kpos, causal=causal, window=window,
                      chunk=chunk)
    y = _out_proj(p, out)
    if return_kv:
        return y, (k, v)
    return y


def attn_apply_decode(p: Attention, h, cache: attn.KVCache, pos: int,
                      cfg: ModelConfig, *, window=None, chunk=None):
    """One-token self-attention. h: [B, 1, D]; ``pos`` is the token's
    position as a host int. Returns (y, cache), the cache updated in
    place."""
    if cfg.use_mla:
        return _mla_apply_decode(p, h, cache, pos, cfg)
    positions = torch.arange(pos, pos + 1, dtype=torch.int32,
                             device=h.device)
    q, k, v = _qkv(p, h, positions, cfg)
    cache = attn.cache_write(cache, k, v, pos)
    out = attn.decode_attend(q, cache, pos, window=window, chunk=chunk)
    return _out_proj(p, out), cache


def attn_prefill(p: Attention, h, positions, cfg: ModelConfig,
                 capacity: int, *, window=None, chunk=None):
    """Full-seq attention that also builds the decode cache (ring
    layout)."""
    if cfg.use_mla:
        y, (c, kr) = _mla_apply_full(p, h, positions, cfg, return_kv=True)
        zc = attn.init_mla_cache(h.shape[0], capacity, cfg.kv_lora_rank,
                                 cfg.rope_head_dim, h.dtype, h.device)
        return y, attn.cache_prefill(zc, c, kr)
    y, (k, v) = attn_apply_full(p, h, positions, cfg, window=window,
                                chunk=chunk, return_kv=True)
    zero = attn.init_kv_cache(h.shape[0], capacity, cfg.num_kv_heads,
                              cfg.resolved_head_dim, h.dtype, h.device)
    return y, attn.cache_prefill(zero, k, v)


# ---------------------------------------------------------------------------
# MLA sublayer (deepseek-v2)
# ---------------------------------------------------------------------------
def _mla_project(p: MLAttention, h, positions, cfg: ModelConfig):
    """q_nope [B, S, H, Dh], q_rope [B, S, H, Dr] (roped), the normed
    latent c [B, S, r] and the roped shared key kr [B, S, Dr]."""
    Dh, r = cfg.resolved_head_dim, cfg.kv_lora_rank
    hq = h
    if cfg.q_lora_rank:
        hq = rms_norm(h @ p.w_dq, p.q_norm_lora, cfg.norm_eps)
    qall = _project(hq, p.wq)
    q_nope, q_rope = qall[..., :Dh], qall[..., Dh:]
    q_rope = apply_rope(q_rope, positions, 1.0, cfg.rope_theta)
    ckr = h @ p.w_dkv
    c = rms_norm(ckr[..., :r], p.kv_norm, cfg.norm_eps)
    kr = apply_rope(ckr[..., None, r:], positions, 1.0,
                    cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c, kr


def _mla_apply_full(p: MLAttention, h, positions, cfg: ModelConfig,
                    return_kv: bool = False):
    q_nope, q_rope, c, kr = _mla_project(p, h, positions, cfg)
    out = attn.mla_attend_full(q_nope, q_rope, c, kr, p.w_uk, p.w_uv,
                               positions, positions, causal=True)
    y = _out_proj(p, out)
    if return_kv:
        return y, (c, kr)
    return y


def _mla_apply_decode(p: MLAttention, h, cache: attn.MLACache, pos: int,
                      cfg: ModelConfig):
    positions = torch.arange(pos, pos + 1, dtype=torch.int32,
                             device=h.device)
    q_nope, q_rope, c, kr = _mla_project(p, h, positions, cfg)
    cache = attn.mla_cache_write(cache, c, kr, pos)
    out = attn.mla_decode_attend(q_nope, q_rope, cache, p.w_uk, p.w_uv, pos)
    return _out_proj(p, out), cache


# ---------------------------------------------------------------------------
# Dense decoder layer
# ---------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    def __init__(self, make: Maker, cfg: ModelConfig, prefix: str = ""):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.ln1 = make(prefix + "ln1", (D,), "zeros")
        self.attn = attn_build(make, cfg, prefix=prefix + "attn.")
        self.ln2 = make(prefix + "ln2", (D,), "zeros")
        self.mlp = MLP(make, cfg.d_model, cfg.d_ff, prefix=prefix + "mlp.")

    def forward(self, x, positions):
        return layer_apply(self, x, positions, self.cfg,
                           window=self.cfg.sliding_window,
                           chunk=self.cfg.attention_chunk)


def layer_build(make: Maker, cfg: ModelConfig, index: int) -> DecoderLayer:
    return DecoderLayer(make, cfg, prefix=f"layers.{index}.")


def layer_apply(lp: DecoderLayer, x, positions, cfg: ModelConfig, *,
                window=None, chunk=None):
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + attn_apply_full(lp.attn, h, positions, cfg, window=window,
                            chunk=chunk)
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h)


def layer_prefill(lp: DecoderLayer, x, positions, cfg: ModelConfig,
                  capacity: int, *, window=None, chunk=None):
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    y, cache = attn_prefill(lp.attn, h, positions, cfg, capacity,
                            window=window, chunk=chunk)
    x = x + y
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h), cache


def layer_decode(lp: DecoderLayer, x, cache, pos: int, cfg: ModelConfig, *,
                 window=None, chunk=None):
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    y, cache = attn_apply_decode(lp.attn, h, cache, pos, cfg, window=window,
                                 chunk=chunk)
    x = x + y
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h), cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
class Transformer(nn.Module):
    """embed [V, D], layers.<i>, final_norm [D], lm_head [D, V] (absent
    with tied embeddings). The VLM's backbone is this decoder too."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family not in (DENSE, VLM):
            raise ValueError(f"{cfg.name} is not a dense decoder")
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


def build_params(cfg: ModelConfig, seed: int = 0,
                 device="cuda") -> Transformer:
    """Random weights from ``seed``, made on ``device``."""
    return Transformer(cfg, seed, device)


def embed_tokens(model: Transformer, tokens, cfg: ModelConfig,
                 extra_embeds=None):
    """Token embeddings [B, S, D]; ``extra_embeds`` [B, P, D] (the VLM's
    patches) are prepended in the embeddings' dtype."""
    x = model.embed[tokens]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return batch_sharded(x)


def unembed(model: Transformer, x, cfg: ModelConfig):
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ model.embed.T
    return x @ model.lm_head


def positions_for(x: torch.Tensor) -> torch.Tensor:
    """Prefill positions 0..S-1 of activations x [B, S, D]."""
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def forward(model: Transformer, tokens, cfg: ModelConfig,
            extra_embeds=None):
    """tokens: [B, S_text] int32 -> logits [B, S_total, V]. Each layer
    is checkpointed under ``cfg.remat`` when autograd records."""
    x = embed_tokens(model, tokens, cfg, extra_embeds)
    positions = positions_for(x)

    def body(lp, x):
        return layer_apply(lp, x, positions, cfg, window=cfg.sliding_window,
                           chunk=cfg.attention_chunk)
    for lp in model.layers:
        x = remat(cfg, body, lp, x)
    return unembed(model, x, cfg)


def prefill(model: Transformer, tokens, cfg: ModelConfig,
            extra_embeds=None, extra_capacity: int = 0):
    """Returns (last-position logits [B, 1, V], one cache per layer)."""
    x = embed_tokens(model, tokens, cfg, extra_embeds)
    positions = positions_for(x)
    capacity = attn.cache_capacity(x.shape[1] + extra_capacity,
                                   cfg.sliding_window, cfg.attention_chunk)
    caches = []
    for lp in model.layers:
        x, cache = layer_prefill(lp, x, positions, cfg, capacity,
                                 window=cfg.sliding_window,
                                 chunk=cfg.attention_chunk)
        caches.append(cache)
    return unembed(model, x[:, -1:, :], cfg), caches


def decode_step(model: Transformer, token, pos: int, caches,
                cfg: ModelConfig):
    """token: [B, 1] int32 at position ``pos`` (a host int); caches: one
    per layer, updated in place. -> (logits [B, 1, V], caches)."""
    x = embed_tokens(model, token, cfg)
    new_caches = []
    for lp, cache in zip(model.layers, caches):
        x, cache = layer_decode(lp, x, cache, pos, cfg,
                                window=cfg.sliding_window,
                                chunk=cfg.attention_chunk)
        new_caches.append(cache)
    return unembed(model, x, cfg), new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int,
                       device="cuda"):
    """Empty caches, one per layer, sized for decoding at seq_len (the
    JAX package stacks them over layers). Every layer's ring has the one
    capacity ``cache_capacity(seq_len, window, chunk)``, the MoE family's
    full-attention layers too, as in the JAX package."""
    capacity = attn.cache_capacity(seq_len, cfg.sliding_window,
                                   cfg.attention_chunk)
    dt = torch_dtype(cfg.dtype)
    if cfg.use_mla:
        return [attn.init_mla_cache(batch, capacity, cfg.kv_lora_rank,
                                    cfg.rope_head_dim, dt, device)
                for _ in range(cfg.num_layers)]
    return [attn.init_kv_cache(batch, capacity, cfg.num_kv_heads,
                               cfg.resolved_head_dim, dt, device)
            for _ in range(cfg.num_layers)]
