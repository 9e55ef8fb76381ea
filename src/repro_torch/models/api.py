"""Uniform model API (``repro.models.api``) for the families this package
runs so far: the dense decoder.

    model = build_params(cfg, seed, device)   # nn.Module, random weights
    logits, aux = forward(model, batch, cfg)
    batch = make_batch(cfg, batch, seq_len, generator, device)
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.config import DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models import transformer

#: the slice of the port that brings each family still missing
_LATER = {
    SSM: "the decode slice (mamba2, with decode_attention)",
    HYBRID: "the recurrentgemma slice (rglru_scan)",
    MOE: "the MoE/MLA slice",
    ENCDEC: "the encoder-decoder slice",
    VLM: "the VLM slice",
}


def _mod(cfg: ModelConfig):
    if cfg.family == DENSE:
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet; it comes "
        f"with {_LATER.get(cfg.family, 'a later slice')}")


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return _mod(cfg).build_params(cfg, seed, device)


def forward(model, batch, cfg: ModelConfig) -> Tuple[Any, Any]:
    """Returns (logits, aux_loss)."""
    logits = _mod(cfg).forward(model, batch, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def make_batch(cfg: ModelConfig, batch: int, seq_len: int,
               generator: Optional[torch.Generator] = None, device="cuda"):
    """Random int32 tokens [batch, seq_len] (int32 as in the JAX package,
    so the two frameworks' segments get the same KernelIDs). Without a
    generator the tokens are those of seed 0, as the JAX package's
    ``key=None`` gives key 0."""
    _mod(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         dtype=torch.int32, device=device,
                         generator=generator)
