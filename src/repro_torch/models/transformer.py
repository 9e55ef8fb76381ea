"""Dense decoder-only transformer LM (GQA / MQA / qk_norm / partial rotary /
sliding-window / chunked attention): ``repro.models.transformer`` as
PyTorch modules, with full-sequence forward, prefill and one-token decode.
Also provides the attention sublayer the hybrid and the encoder-decoder
use, and the decoder that the VLM runs over its patches and tokens.

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
                                       rms_norm, torch_dtype)


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


def attn_build(make: Maker, cfg: ModelConfig, prefix: str = "") -> Attention:
    if cfg.use_mla:
        raise NotImplementedError("MLA attention (deepseek-v2) comes with "
                                  "the MoE/MLA slice")
    return Attention(make, cfg, prefix)


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", h, w) as one matrix product."""
    return (h @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


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
    return out.reshape(B, S, -1) @ p.wo.reshape(-1, p.wo.shape[-1])


def attn_apply_full(p: Attention, h, positions, cfg: ModelConfig, *,
                    window: Optional[int] = None,
                    chunk: Optional[int] = None, causal: bool = True,
                    kv=None, return_kv: bool = False):
    """Full-sequence self-attention sublayer (causal unless ``causal`` is
    false), or cross-attention with ``kv=(k, v, kpos)``: then q alone is
    projected and q-normed, not roped, and k [B, Sk, Kh, Dh] and v are
    used as given. With ``return_kv`` also its k and v (for the decode
    cache)."""
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
    y, (k, v) = attn_apply_full(p, h, positions, cfg, window=window,
                                chunk=chunk, return_kv=True)
    zero = attn.init_kv_cache(h.shape[0], capacity, cfg.num_kv_heads,
                              cfg.resolved_head_dim, h.dtype, h.device)
    return y, attn.cache_prefill(zero, k, v)


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
    return x


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
    """tokens: [B, S_text] int32 -> logits [B, S_total, V]."""
    x = embed_tokens(model, tokens, cfg, extra_embeds)
    positions = positions_for(x)
    for lp in model.layers:
        x = layer_apply(lp, x, positions, cfg, window=cfg.sliding_window,
                        chunk=cfg.attention_chunk)
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
    JAX package stacks them over layers)."""
    if cfg.use_mla:
        raise NotImplementedError("MLA caches (deepseek-v2) come with the "
                                  "MoE/MLA slice")
    capacity = attn.cache_capacity(seq_len, cfg.sliding_window,
                                   cfg.attention_chunk)
    return [attn.init_kv_cache(batch, capacity, cfg.num_kv_heads,
                               cfg.resolved_head_dim, torch_dtype(cfg.dtype),
                               device)
            for _ in range(cfg.num_layers)]
