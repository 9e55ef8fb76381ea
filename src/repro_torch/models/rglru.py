"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU recurrent
blocks interleaved with local (sliding-window) attention blocks, pattern
(rec, rec, attn) repeating: ``repro.models.rglru`` as PyTorch modules.

The RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t runs
through the ``rglru_scan`` kernel for full sequences (forward, prefill;
the initial state is folded in inside the kernel) and as a single fused
update for decode. Attention blocks use the dense attention sublayer with
``local_window`` as the window, and the ring-buffer KV cache for decode.

Parameters keep the JAX names: the JAX tree's list ``blocks`` becomes the
module list ``blocks.<i>`` (``repro_torch.bridge`` walks it), and each
parameter is drawn from the name the JAX package gives it (``b<i>_ln``,
...). Embeddings are tied and not scaled, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import HYBRID, ModelConfig
from repro_torch.kernels.rglru_scan import ops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (MLP, Maker, mlp_apply, remat,
                                       rms_norm, torch_dtype)
from repro_torch.models.mamba2 import _causal_conv
from repro_torch.sharding import context as shctx
from repro_torch.sharding.context import batch_sharded, constrain

C_SCALE = 8.0  # RG-LRU "c" constant
# gather the gates' input over the model axis once (the JAX package's
# REPRO_GATE_GATHER; off by default there too)
GATE_GATHER = os.environ.get("REPRO_GATE_GATHER", "0") == "1"


class RecCache(NamedTuple):
    h: torch.Tensor       # [B, W] fp32 recurrent state
    conv: torch.Tensor    # [B, K-1, W] conv history


def block_kinds(cfg: ModelConfig) -> List[str]:
    """Static per-layer kind list, e.g. 38 layers of (rec, rec, attn)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


class RecBlock(nn.Module):
    """RG-LRU block + MLP: ln, w_y, w_gate, conv, w_r, w_i, lam, w_out,
    ln2, mlp (the JAX shapes)."""

    def __init__(self, make: Maker, cfg: ModelConfig, i: int):
        super().__init__()
        D, W = cfg.d_model, cfg.resolved_lru_width
        K = cfg.ssm_conv or 4
        pre = f"b{i}_"
        self.ln = make(pre + "ln", (D,), "zeros")
        self.w_y = make(pre + "w_y", (D, W))
        self.w_gate = make(pre + "w_gate", (D, W))
        self.conv = make(pre + "conv", (K, W), scale=0.5)
        self.w_r = make(pre + "w_r", (W, W), scale=0.5)
        self.w_i = make(pre + "w_i", (W, W), scale=0.5)
        self.lam = make(pre + "lam", (W,), "ones")
        self.w_out = make(pre + "w_out", (W, D))
        self.ln2 = make(pre + "ln2", (D,), "zeros")
        self.mlp = MLP(make, D, cfg.d_ff, prefix=pre)


class AttnBlock(nn.Module):
    """Local attention block + MLP: ln1, attn, ln2, mlp."""

    def __init__(self, make: Maker, cfg: ModelConfig, i: int):
        super().__init__()
        D = cfg.d_model
        pre = f"b{i}_"
        self.ln1 = make(pre + "ln1", (D,), "zeros")
        self.attn = tfm.attn_build(make, cfg, prefix=pre)
        self.ln2 = make(pre + "ln2", (D,), "zeros")
        self.mlp = MLP(make, D, cfg.d_ff, prefix=pre)


class Hybrid(nn.Module):
    """embed [V, D], blocks.<i> (RecBlock / AttnBlock), final_norm [D],
    lm_head [D, V] (absent with tied embeddings)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family != HYBRID:
            raise ValueError(f"{cfg.name} is not a hybrid model")
        self.cfg = cfg
        make = Maker(seed, torch_dtype(cfg.dtype), device)
        self.embed = make("embed", (cfg.vocab_size, cfg.d_model), "embed")
        self.blocks = nn.ModuleList(
            (RecBlock if kind == "rec" else AttnBlock)(make, cfg, i)
            for i, kind in enumerate(block_kinds(cfg)))
        self.final_norm = make("final_norm", (cfg.d_model,), "zeros")
        if not cfg.tie_embeddings:
            self.lm_head = make("lm_head", (cfg.d_model, cfg.vocab_size))

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Hybrid:
    """Random weights from ``seed``, made on ``device``."""
    return Hybrid(cfg, seed, device)


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------
def _rglru_gates(lp: RecBlock, y, cfg: ModelConfig):
    """y: [B,S,W] post-conv. Returns (a [B,S,W] fp32, gated input fp32).
    Under a mesh with ``REPRO_GATE_GATHER=1`` the gates' input is gathered
    over W once, as in the JAX package."""
    y_in = y
    if GATE_GATHER:
        y_in = constrain(y, "batch", None, None)   # gather W once (bf16)
    r = torch.sigmoid((y_in @ lp.w_r).float())
    i = torch.sigmoid((y_in @ lp.w_i).float())
    log_a = -C_SCALE * r * F.softplus(lp.lam.float())
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
             * (i * y.float()))
    return a, gated


def rglru_scan_full(a, b, h0: Optional[torch.Tensor] = None):
    """h_t = a_t * h_{t-1} + b_t over axis 1. a/b: [B,S,W] fp32; h0 [B,W]
    is folded in by the kernel. Under a mesh the three are pinned
    batch- and width-sharded, so the kernel runs on the local shard."""
    a = constrain(a, "batch", None, "model")
    b = constrain(b, "batch", None, "model")
    if h0 is not None:
        h0 = constrain(h0, "batch", "model")
    return ops.rglru_scan(a, b, h0)


def _gate_and_y(lp: RecBlock, x, cfg: ModelConfig):
    h = rms_norm(x, lp.ln, cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu((h @ lp.w_gate).float(), approximate="tanh").to(h.dtype)
    return gate, h @ lp.w_y


def _rec_apply(lp: RecBlock, x, cfg: ModelConfig,
               cache: Optional[RecCache] = None, return_cache: bool = False):
    gate, y = _gate_and_y(lp, x, cfg)
    y, buf = _causal_conv(y, lp.conv, None if cache is None else cache.conv)
    a, b = _rglru_gates(lp, y, cfg)
    hs = rglru_scan_full(a, b, None if cache is None else cache.h)
    out = batch_sharded((hs.to(x.dtype) * gate) @ lp.w_out)
    x = x + out
    if return_cache:
        # copies, so the cache does not hold the [B, S, W] buffers
        return x, RecCache(hs[:, -1].clone(), buf.clone())
    return x


def _rec_decode(lp: RecBlock, x, cache: RecCache, cfg: ModelConfig):
    gate, y = _gate_and_y(lp, x, cfg)
    y, buf = _causal_conv(y, lp.conv, cache.conv)
    a, b = _rglru_gates(lp, y, cfg)
    h_new = a[:, 0] * cache.h + b[:, 0]                    # [B, W]
    out = batch_sharded((h_new[:, None].to(x.dtype) * gate) @ lp.w_out)
    return x + out, RecCache(h_new, buf)


def _mlp_res(lp, x, cfg: ModelConfig):
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h)


def rec_block_apply(lp: RecBlock, x, cfg: ModelConfig):
    """One rec block of the forward pass (a serving segment)."""
    return _mlp_res(lp, _rec_apply(lp, x, cfg), cfg)


def attn_block_apply(lp: AttnBlock, x, cfg: ModelConfig):
    """One attention block of the forward pass (a serving segment)."""
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + tfm.attn_apply_full(lp.attn, h, tfm.positions_for(x), cfg,
                                window=cfg.local_window)
    return _mlp_res(lp, x, cfg)


# ---------------------------------------------------------------------------
# Model (python loop over heterogeneous blocks)
# ---------------------------------------------------------------------------
def forward(model: Hybrid, tokens, cfg: ModelConfig):
    """tokens: [B, S] int32 -> logits [B, S, V]. Each block is
    checkpointed under ``cfg.remat`` when autograd records."""
    x = tfm.embed_tokens(model, tokens, cfg)
    for lp in model.blocks:
        x = remat(cfg, rec_block_apply if isinstance(lp, RecBlock)
                  else attn_block_apply, lp, x, cfg)
    return tfm.unembed(model, x, cfg)


def prefill(model: Hybrid, tokens, cfg: ModelConfig,
            extra_capacity: int = 0):
    """Returns (last-position logits [B, 1, V], one cache per block)."""
    x = tfm.embed_tokens(model, tokens, cfg)
    S = x.shape[1]
    positions = tfm.positions_for(x)
    capacity = min(S + extra_capacity, cfg.local_window or S)
    caches = []
    for lp in model.blocks:
        if isinstance(lp, RecBlock):
            x, cache = _rec_apply(lp, x, cfg, return_cache=True)
        else:
            h = rms_norm(x, lp.ln1, cfg.norm_eps)
            y, cache = tfm.attn_prefill(lp.attn, h, positions, cfg, capacity,
                                        window=cfg.local_window)
            x = x + y
        x = _mlp_res(lp, x, cfg)
        caches.append(cache)
    return tfm.unembed(model, x[:, -1:, :], cfg), caches


def decode_step(model: Hybrid, token, pos: int, caches, cfg: ModelConfig):
    """token: [B, 1] int32 at position ``pos`` (a host int). Returns
    (logits [B, 1, V], caches); KV caches are updated in place."""
    x = tfm.embed_tokens(model, token, cfg)
    new_caches = []
    for lp, cache in zip(model.blocks, caches):
        if isinstance(lp, RecBlock):
            x, cache = _rec_decode(lp, x, cache, cfg)
        else:
            h = rms_norm(x, lp.ln1, cfg.norm_eps)
            y, cache = tfm.attn_apply_decode(lp.attn, h, cache, pos, cfg,
                                             window=cfg.local_window)
            x = x + y
        x = _mlp_res(lp, x, cfg)
        new_caches.append(cache)
    return tfm.unembed(model, x, cfg), new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int,
                       device="cuda"):
    dt = torch_dtype(cfg.dtype)
    W = cfg.resolved_lru_width
    K = cfg.ssm_conv or 4
    capacity = min(seq_len, cfg.local_window or seq_len)
    caches = []
    for kind in block_kinds(cfg):
        if kind == "rec":
            caches.append(RecCache(
                shctx.zeros((batch, W), torch.float32, device, "batch",
                            "model"),
                shctx.zeros((batch, K - 1, W), dt, device, "batch", None,
                            "model")))
        else:
            caches.append(attn.init_kv_cache(batch, capacity,
                                             cfg.num_kv_heads,
                                             cfg.resolved_head_dim, dt,
                                             device))
    return caches
