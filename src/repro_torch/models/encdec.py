"""Encoder-decoder backbone (seamless-m4t-medium, arXiv:2308.11596):
``repro.models.encdec`` as PyTorch modules.

The modality frontend (mel-spectrogram + conv feature extractor) is a
stub: the encoder consumes precomputed frame embeddings [B, Sf, D]
(``api.make_batch``). The backbone is a bidirectional encoder (with
rope) and a causal decoder whose layers add cross-attention over the
encoder's output. Cross-attention is non-causal with no window or chunk,
so every decoder position sees every frame; it runs the flash attention
kernel with Sq != Sk, also at decode time (Sq = 1), as the JAX package's
``attn_apply_full`` does, never the decode kernel, whose causal mask on
the token's position would drop the frames past it.

State-dict keys are the JAX tree paths with the stacked ``enc_layers``
and ``dec_layers`` split into ``enc_layers.<i>`` / ``dec_layers.<i>``
(``repro_torch.bridge``). Parameter names given to the ``Maker`` carry
the JAX package's prefixes (``enc_``, ``dec_``, ``dec_x_``) after the
layer's path, so each layer draws its own weights from the JAX
distributions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.config import ENCDEC, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (MLP, Maker, mlp_apply, rms_norm,
                                       torch_dtype)


class DecCache(NamedTuple):
    self_kv: attn.KVCache
    cross_k: torch.Tensor      # [B, Sf, Kh, Dh], fixed after prefill
    cross_v: torch.Tensor


class EncoderLayer(nn.Module):
    def __init__(self, make: Maker, cfg: ModelConfig, index: int):
        super().__init__()
        D, pre = cfg.d_model, f"enc_layers.{index}.enc_"
        self.ln1 = make(pre + "ln1", (D,), "zeros")
        self.attn = tfm.attn_build(make, cfg, prefix=pre)
        self.ln2 = make(pre + "ln2", (D,), "zeros")
        self.mlp = MLP(make, D, cfg.d_ff, prefix=pre)


class DecoderLayer(nn.Module):
    def __init__(self, make: Maker, cfg: ModelConfig, index: int):
        super().__init__()
        D, pre = cfg.d_model, f"dec_layers.{index}.dec_"
        self.ln1 = make(pre + "ln1", (D,), "zeros")
        self.attn = tfm.attn_build(make, cfg, prefix=pre)
        self.lnx = make(pre + "lnx", (D,), "zeros")
        self.xattn = tfm.attn_build(make, cfg, prefix=pre + "x_")
        self.ln2 = make(pre + "ln2", (D,), "zeros")
        self.mlp = MLP(make, D, cfg.d_ff, prefix=pre)


class EncDec(nn.Module):
    """embed [V, D], enc_in [D, D], enc_layers.<i>, enc_norm [D],
    dec_layers.<i>, final_norm [D], lm_head [D, V] (absent with tied
    embeddings)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family != ENCDEC:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        self.cfg = cfg
        make = Maker(seed, torch_dtype(cfg.dtype), device)
        D = cfg.d_model
        Le = cfg.num_encoder_layers or cfg.num_layers
        Ld = cfg.num_decoder_layers or cfg.num_layers
        self.embed = make("embed", (cfg.vocab_size, D), "embed")
        self.enc_in = make("enc_in", (D, D))
        self.enc_layers = nn.ModuleList(EncoderLayer(make, cfg, i)
                                        for i in range(Le))
        self.enc_norm = make("enc_norm", (D,), "zeros")
        self.dec_layers = nn.ModuleList(DecoderLayer(make, cfg, i)
                                        for i in range(Ld))
        self.final_norm = make("final_norm", (D,), "zeros")
        if not cfg.tie_embeddings:
            self.lm_head = make("lm_head", (D, cfg.vocab_size))

    def forward(self, batch):
        return forward(self, batch, self.cfg)


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> EncDec:
    """Random weights from ``seed``, made on ``device``."""
    return EncDec(cfg, seed, device)


def enc_layer_apply(lp: EncoderLayer, x, cfg: ModelConfig):
    """One encoder layer: bidirectional self-attention with rope over
    positions 0..Sf-1, then the MLP."""
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + tfm.attn_apply_full(lp.attn, h, tfm.positions_for(x), cfg,
                                causal=False)
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h)


def encode(model: EncDec, frames, cfg: ModelConfig):
    """frames: [B, Sf, D] stub embeddings -> encoder output [B, Sf, D]."""
    x = frames.to(torch_dtype(cfg.dtype)) @ model.enc_in
    for lp in model.enc_layers:
        x = enc_layer_apply(lp, x, cfg)
    return rms_norm(x, model.enc_norm, cfg.norm_eps)


def _cross_kv(lp: DecoderLayer, enc_out, cfg: ModelConfig):
    """The cross-attention's k and v [B, Sf, Kh, Dh] of the encoder's
    output (k q-normed where the config norms, never roped)."""
    k = tfm._project(enc_out, lp.xattn.wk)
    v = tfm._project(enc_out, lp.xattn.wv)
    if cfg.qk_norm:
        k = rms_norm(k, lp.xattn.k_norm, cfg.norm_eps)
    return k, v


def _cross(lp: DecoderLayer, x, positions, k, v, cfg: ModelConfig):
    """x + cross-attention of x over the frames' k and v."""
    h = rms_norm(x, lp.lnx, cfg.norm_eps)
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    return x + tfm.attn_apply_full(lp.xattn, h, positions, cfg,
                                   causal=False, kv=(k, v, kpos))


def _dec_layer(lp: DecoderLayer, x, positions, enc_out, cfg: ModelConfig):
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + tfm.attn_apply_full(lp.attn, h, positions, cfg)
    x = _cross(lp, x, positions, *_cross_kv(lp, enc_out, cfg), cfg)
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h)


def forward(model: EncDec, batch, cfg: ModelConfig):
    """batch: (frames [B, Sf, D], tokens [B, St]) -> logits [B, St, V]."""
    frames, tokens = batch
    enc_out = encode(model, frames, cfg)
    x = tfm.embed_tokens(model, tokens, cfg)
    positions = tfm.positions_for(x)
    for lp in model.dec_layers:
        x = _dec_layer(lp, x, positions, enc_out, cfg)
    return tfm.unembed(model, x, cfg)


def prefill(model: EncDec, batch, cfg: ModelConfig, extra_capacity: int = 0):
    """Returns (last-position logits [B, 1, V], one ``DecCache`` per
    decoder layer: the self-attention's cache of capacity St +
    ``extra_capacity`` and the cross-attention's k and v)."""
    frames, tokens = batch
    enc_out = encode(model, frames, cfg)
    x = tfm.embed_tokens(model, tokens, cfg)
    positions = tfm.positions_for(x)
    capacity = x.shape[1] + extra_capacity
    caches = []
    for lp in model.dec_layers:
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        y, self_cache = tfm.attn_prefill(lp.attn, h, positions, cfg,
                                         capacity)
        k, v = _cross_kv(lp, enc_out, cfg)
        x = _cross(lp, x + y, positions, k, v, cfg)
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, h)
        caches.append(DecCache(self_cache, k, v))
    return tfm.unembed(model, x[:, -1:, :], cfg), caches


def decode_step(model: EncDec, token, pos: int, caches, cfg: ModelConfig):
    """token: [B, 1] int32 at host-int position ``pos``; caches: one
    ``DecCache`` per decoder layer, the self-attention's updated in
    place. -> (logits [B, 1, V], caches)."""
    x = tfm.embed_tokens(model, token, cfg)
    positions = torch.arange(pos, pos + 1, dtype=torch.int32,
                             device=x.device)
    new_caches = []
    for lp, cache in zip(model.dec_layers, caches):
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        y, self_cache = tfm.attn_apply_decode(lp.attn, h, cache.self_kv,
                                              pos, cfg)
        x = _cross(lp, x + y, positions, cache.cross_k, cache.cross_v, cfg)
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, h)
        new_caches.append(DecCache(self_cache, cache.cross_k, cache.cross_v))
    return tfm.unembed(model, x, cfg), new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int,
                       device="cuda"):
    """Empty caches, one per decoder layer (the JAX package stacks them):
    a self-attention cache of ``seq_len`` slots and zero cross k and v
    over the config's ``encoder_frames``."""
    dt = torch_dtype(cfg.dtype)
    Ld = cfg.num_decoder_layers or cfg.num_layers
    Kh, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, cfg.encoder_frames, Kh, Dh)
    return [DecCache(attn.init_kv_cache(batch, seq_len, Kh, Dh, dt, device),
                     torch.zeros(shape, dtype=dt, device=device),
                     torch.zeros(shape, dtype=dt, device=device))
            for _ in range(Ld)]
