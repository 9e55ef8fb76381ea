"""VLM backbone (llava-next-mistral-7b), ``repro.models.vlm``: the dense
decoder consuming anyres patch embeddings from a stub vision frontend
(the ViT and projector are not implemented; ``stub_patches`` supplies
patch embeddings of the right shape, prepended to the text tokens).

The patches and the tokens form one causal sequence 0..P+S-1, so every
attention call is the dense decoder's self-attention over ``arange``
positions, as ``attention.attend`` requires.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import torch_dtype

build_params = tfm.build_params
init_decode_caches = tfm.init_decode_caches
decode_step = tfm.decode_step


def forward(model: tfm.Transformer, batch, cfg: ModelConfig):
    """batch: (patches [B, P, D], tokens [B, St]) -> logits
    [B, P + St, V]."""
    patches, tokens = batch
    return tfm.forward(model, tokens, cfg, extra_embeds=patches)


def prefill(model: tfm.Transformer, batch, cfg: ModelConfig,
            extra_capacity: int = 0):
    patches, tokens = batch
    return tfm.prefill(model, tokens, cfg, extra_embeds=patches,
                       extra_capacity=extra_capacity)


def stub_patches(cfg: ModelConfig, batch: int, dtype=None, device="cuda"):
    """Deterministic stand-in for the vision tower's output: the JAX
    package's ``linspace(-0.5, 0.5)`` over P * D values in fp32, cast to
    the config's dtype, broadcast over the batch."""
    dt = dtype or torch_dtype(cfg.dtype)
    P, D = cfg.num_patches, cfg.d_model
    base = torch.linspace(-0.5, 0.5, P * D, dtype=torch.float32,
                          device=device).reshape(1, P, D)
    return base.to(dt).expand(batch, P, D)
