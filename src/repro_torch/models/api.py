"""Uniform model API (``repro.models.api``) for the families this package
runs so far: the dense decoder, the mamba2 SSM, the recurrentgemma
hybrid, the encoder-decoder (seamless-m4t) and the VLM (llava-next).

    model = build_params(cfg, seed, device)   # nn.Module, random weights
    logits, aux = forward(model, batch, cfg)
    logits, caches = prefill(model, batch, cfg)
    logits, caches = decode_step(model, token, pos, caches, cfg)
    caches = init_decode_caches(cfg, batch, seq_len, device)
    batch = make_batch(cfg, batch, seq_len, generator, device)

A batch is int32 tokens [B, S], or a tuple for the encoder-decoder
(frames, tokens) and the VLM (patches, tokens). Caches are one entry per
layer (the JAX package stacks the dense, SSM and encoder-decoder models'
over layers), and ``decode_step`` updates KV caches in place;
``pos`` is a host int, so no layer reads a position back from the card
(the SSM state is position-free and ignores it).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.config import DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models import encdec, mamba2, rglru, transformer, vlm
from repro_torch.models.layers import torch_dtype

#: the slice of the port that brings each family still missing
_LATER = {MOE: "the MoE/MLA slice"}

_MODULES = {DENSE: transformer, SSM: mamba2, HYBRID: rglru, ENCDEC: encdec,
            VLM: vlm}


def _mod(cfg: ModelConfig):
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet; it comes "
        f"with {_LATER.get(cfg.family, 'a later slice')}")


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return _mod(cfg).build_params(cfg, seed, device)


def forward(model, batch, cfg: ModelConfig) -> Tuple[Any, Any]:
    """Returns (logits, aux_loss)."""
    logits = _mod(cfg).forward(model, batch, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(model, batch, cfg: ModelConfig, extra_capacity: int = 0):
    """Returns (last-position logits [B, 1, V], caches)."""
    return _mod(cfg).prefill(model, batch, cfg,
                             extra_capacity=extra_capacity)


def decode_step(model, token, pos: int, caches, cfg: ModelConfig):
    """token: [B, 1] int32 at host-int position ``pos``. Returns
    (logits [B, 1, V], caches)."""
    return _mod(cfg).decode_step(model, token, pos, caches, cfg)


def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int,
                       device="cuda"):
    return _mod(cfg).init_decode_caches(cfg, batch, seq_len, device)


def make_batch(cfg: ModelConfig, batch: int, seq_len: int,
               generator: Optional[torch.Generator] = None, device="cuda"):
    """Random int32 tokens [batch, seq_len] (int32 as in the JAX package,
    so the two frameworks' segments get the same KernelIDs); for the
    encoder-decoder (frames [batch, Sf, D] of 0.02 * N(0, 1) in the
    config's dtype, tokens), for the VLM (the stub patches, tokens
    [batch, max(seq_len - P, 1)]). Without a generator the draws are
    those of seed 0, as the JAX package's ``key=None`` gives key 0."""
    _mod(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (batch, n),
                             dtype=torch.int32, device=device,
                             generator=generator)
    if cfg.family == ENCDEC:
        frames = torch.randn((batch, cfg.encoder_frames, cfg.d_model),
                             device=device, generator=generator) * 0.02
        return (frames.to(torch_dtype(cfg.dtype)), tokens(seq_len))
    if cfg.family == VLM:
        return (vlm.stub_patches(cfg, batch, device=device),
                tokens(max(seq_len - cfg.num_patches, 1)))
    return tokens(seq_len)
