"""Uniform model API (``repro.models.api``) over all architecture
families: the dense decoder, the MoE decoder (llama4-scout, deepseek-v2
with MLA), the mamba2 SSM, the recurrentgemma hybrid, the
encoder-decoder (seamless-m4t) and the VLM (llava-next).

    model = build_params(cfg, seed, device)   # nn.Module, random weights
    logits, aux = forward(model, batch, cfg)
    logits, caches = prefill(model, batch, cfg)
    logits, caches = decode_step(model, token, pos, caches, cfg)
    caches = init_decode_caches(cfg, batch, seq_len, device)
    batch = make_batch(cfg, batch, seq_len, generator, device)
    labels = batch_labels(cfg, batch)
    loss = loss_fn(logits, labels[:, :logits.shape[1]], aux)

A batch is int32 tokens [B, S], or a tuple for the encoder-decoder
(frames, tokens) and the VLM (patches, tokens). Caches are one entry per
layer (the JAX package stacks the dense, MoE, SSM and encoder-decoder
models'
over layers), and ``decode_step`` updates KV caches in place;
``pos`` is a host int, so no layer reads a position back from the card
(the SSM state is position-free and ignores it).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.config import DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models import encdec, mamba2, moe, rglru, transformer, vlm
from repro_torch.models.layers import torch_dtype

_MODULES = {DENSE: transformer, MOE: moe, SSM: mamba2, HYBRID: rglru,
            ENCDEC: encdec, VLM: vlm}


def _mod(cfg: ModelConfig):
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    raise NotImplementedError(f"{cfg.name}: no model family "
                              f"{cfg.family!r} in this package")


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return _mod(cfg).build_params(cfg, seed, device)


def forward(model, batch, cfg: ModelConfig) -> Tuple[Any, Any]:
    """Returns (logits, aux_loss): the MoE family's load-balance loss
    summed over its layers, zero for the others."""
    if cfg.family == MOE:
        return moe.forward(model, batch, cfg)
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


def batch_labels(cfg: ModelConfig, batch) -> torch.Tensor:
    """Next-token labels aligned to the logits of ``forward(batch)``:
    the tokens rolled by one (the last label is the first token), and
    -100 (ignored) over the VLM's patches."""
    if cfg.family == ENCDEC:
        return torch.roll(batch[1], -1, dims=1)
    if cfg.family == VLM:
        patches, tokens = batch
        pad = torch.full((tokens.shape[0], patches.shape[1]), -100,
                         dtype=torch.int32, device=tokens.device)
        return torch.cat([pad, torch.roll(tokens, -1, dims=1)], dim=1)
    return torch.roll(batch, -1, dims=1)


def loss_fn(logits, labels, aux, aux_weight: float = 0.01):
    """Masked next-token cross entropy (labels < 0 ignored) in fp32: the
    logsumexp minus the picked logit, summed over the valid labels and
    divided by their count (at least 1), plus ``aux_weight * aux``.

    Under a mesh the logits stay vocab-sharded, as GSPMD keeps them:
    each rank takes the logsumexp of its vocab shard and the label's
    logit where its shard holds the label (0 elsewhere), and these are
    combined across the mesh dims that shard the vocab (lse = M +
    log(sum exp(lse_r - M)), M the ranks' max; the picked logits summed).
    Only [B, S] tensors cross ranks. Over one shard the combine is exact
    (exp(0) = 1, log(1) = 0), so a (1, 1) mesh gives the un-meshed bits."""
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor):
        nll, valid = _sharded_nll(logits, labels)
    else:
        nll, valid = _nll(logits, labels, 0, None), labels >= 0
    return nll.sum() / torch.clamp_min(valid.sum(), 1) + aux_weight * aux


def _nll(logits, labels, lo: int, combine):
    """Per-token masked cross entropy of logits that hold the vocab
    entries [lo, lo + V_local); ``combine(x, op)`` reduces a per-token
    value across the vocab's shards (None: the whole vocab is here)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    valid = labels >= 0
    own = valid & (labels >= lo) & (labels < lo + lg.shape[-1])
    lab = torch.where(own, labels - lo, 0).long()
    picked = torch.where(own, torch.gather(lg, -1, lab[..., None])[..., 0],
                         0.0)
    if combine is not None:
        top = combine(lse.detach(), "max")
        lse = torch.log(combine(torch.exp(lse - top), "sum")) + top
        picked = combine(picked, "sum")
    return (lse - picked) * valid.float()


def _sharded_nll(logits, labels):
    """(nll, valid) as ``DTensor``s placed as the labels (a ``DTensor``
    on the logits' mesh) are redistributed: the logits' placements with
    the vocab's mesh dims replicated. The logits' gradient comes back
    vocab-sharded; the sums crossing ranks pass it through unchanged
    (``from_local`` of a ``Partial``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = {md for md, p in enumerate(logits.placements)
             if p.is_shard() and p.dim % logits.ndim == last}
    lpl = [Replicate() if md in vocab or p.is_partial() else p
           for md, p in enumerate(logits.placements)]
    logits = logits.redistribute(mesh, [
        p if md in vocab else lpl[md]
        for md, p in enumerate(logits.placements)])
    labels = labels.redistribute(mesh, lpl)
    _, off = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)

    def combine(x, op):
        pl = [Partial(op) if md in vocab else p for md, p in enumerate(lpl)]
        return DTensor.from_local(x, mesh, pl, run_check=False).redistribute(
            mesh, lpl).to_local()
    nll = _nll(logits.to_local(), labels.to_local(), off[last],
               combine if vocab else None)
    return DTensor.from_local(nll, mesh, lpl, run_check=False), labels >= 0
