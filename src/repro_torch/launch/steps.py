"""Step builders (``repro.launch.steps``): train_step / prefill_step /
serve_step as functions with example arguments per (architecture x input
shape).

Each builder returns ``(fn, example_args)``. The example arguments are
``device="meta"`` tensors (the model built on the meta device, its
optimizer state, the batch and labels), the counterpart of the JAX
package's ``ShapeDtypeStruct``s: shapes and dtypes, never allocated.
There is no mesh yet: sharding comes with its own slice, so the batch is
one shard. PyTorch runs eagerly, so ``fn`` is the step itself, not a
compiled program.
"""
from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.config import ENCDEC, VLM, InputShape, ModelConfig
from repro_torch.models import api
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.adamw import adamw_init, adamw_update

#: the slice of the port that brings meshes and sharded optimizer state
SHARDING_SLICE = "the sharding slice (ROADMAP queue 1 (g))"


# ---------------------------------------------------------------------------
# Input specs (meta tensors: never allocated)
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, B: int, S: int) -> Any:
    """Model-input stand-ins for a full sequence (train / prefill)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cfg.family == ENCDEC:
        return (meta((B, cfg.encoder_frames, cfg.d_model),
                     torch_dtype(cfg.dtype)), meta((B, S), torch.int32))
    if cfg.family == VLM:
        st = max(S - cfg.num_patches, 1)
        return (meta((B, cfg.num_patches, cfg.d_model),
                     torch_dtype(cfg.dtype)), meta((B, st), torch.int32))
    return meta((B, S), torch.int32)


def label_specs(cfg: ModelConfig, B: int, S: int):
    # labels cover the full (possibly patch-prefixed) logit stream; the
    # train step truncates them to the logits' length
    return torch.empty((B, S), dtype=torch.int32, device="meta")


def params_specs(cfg: ModelConfig):
    """The model on the meta device (raises for a family not ported)."""
    return api.build_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------
ACT_BUDGET_BYTES = 2 << 30   # residual-carry budget per device


def default_grad_accum(cfg: ModelConfig, shape: InputShape) -> int:
    """Microbatch count: smallest power-of-2 A such that the layer-boundary
    residuals (L x (B/A) x S x D x 2 bytes) fit the activation budget,
    with B/A still a whole number. One batch shard until the sharding
    slice."""
    B, S = shape.global_batch, shape.seq_len
    nsh = 1
    L = cfg.num_layers
    A = 1
    while True:
        act = L * (B // nsh / A) * S * cfg.d_model * 2
        if act <= ACT_BUDGET_BYTES or A * 2 > B // nsh:
            return A
        A *= 2


def _split_micro(tree, A: int):
    """A microbatches of a tensor or a tuple of tensors, along dim 0."""
    if isinstance(tree, tuple):
        parts = [_split_micro(x, A) for x in tree]
        return [tuple(p[i] for p in parts) for i in range(A)]
    return list(tree.chunk(A, dim=0))


def make_train_step(cfg: ModelConfig, shape: InputShape, grad_accum: int = 0,
                    moments_dtype=None, zero_pod: bool = False):
    """``fn(model, opt_state, batch, labels) -> (model, opt_state,
    metrics)``: loss and gradients through ``api.forward`` and
    ``api.loss_fn`` (A microbatches: the gradients ``g / A`` accumulated
    in each parameter's dtype, the mean of the losses), then
    ``adamw_update``, in place. The model's parameters must require grad.
    ``moments_dtype`` sets the example state's moments; ``zero_pod``
    (moments sharded across pods) needs a mesh."""
    if zero_pod:
        raise NotImplementedError(f"zero_pod shards the optimizer moments "
                                  f"across pods; it comes with "
                                  f"{SHARDING_SLICE}")
    B, S = shape.global_batch, shape.seq_len
    A = grad_accum or default_grad_accum(cfg, shape)
    if B % A:
        raise ValueError(f"batch {B} does not split into {A} microbatches")
    params_sds = params_specs(cfg)
    opt_sds = adamw_init(dict(params_sds.named_parameters()),
                         moments_dtype=moments_dtype or torch.float32)
    batch_sds = batch_specs(cfg, B, S)
    lbl_sds = label_specs(cfg, B, S)

    def loss_and_grads(model, names, params, batch, labels):
        logits, aux = api.forward(model, batch, cfg)
        loss = api.loss_fn(logits, labels[:, :logits.shape[1]], aux)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), dict(zip(names, grads))

    def train_step(model, opt_state, batch, labels):
        names, params = zip(*model.named_parameters())
        if A == 1:
            lval, grads = loss_and_grads(model, names, params, batch, labels)
        else:
            grads = {n: torch.zeros_like(p) for n, p in zip(names, params)}
            lvals = []
            for b, lab in zip(_split_micro(batch, A),
                              _split_micro(labels, A)):
                lv, g = loss_and_grads(model, names, params, b, lab)
                with torch.no_grad():
                    for n, acc in grads.items():
                        acc.add_((g[n] / A).to(acc.dtype))
                lvals.append(lv)
                del g
            lval = torch.stack(lvals).mean()
        _, new_opt, metrics = adamw_update(grads, opt_state,
                                           dict(zip(names, params)))
        metrics["loss"] = lval
        return model, new_opt, metrics

    return train_step, (params_sds, opt_sds, batch_sds, lbl_sds)


# ---------------------------------------------------------------------------
# prefill_step
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, shape: InputShape):
    """``fn(model, batch) -> (last-position logits, caches)``: ``api.prefill``
    under ``torch.inference_mode``."""
    B, S = shape.global_batch, shape.seq_len
    params_sds = params_specs(cfg)
    batch_sds = batch_specs(cfg, B, S)

    @torch.inference_mode()
    def prefill_step(model, batch):
        return api.prefill(model, batch, cfg)

    return prefill_step, (params_sds, batch_sds)


# ---------------------------------------------------------------------------
# serve_step (decode): ONE token with a KV cache of seq_len
# ---------------------------------------------------------------------------
def make_serve_step(cfg: ModelConfig, shape: InputShape):
    """``fn(model, token, pos, caches) -> (logits, caches)``:
    ``api.decode_step`` under ``torch.inference_mode``. The port's decode
    step takes its position as a host int (no layer reads it back from
    the card), so the example position is the int ``S - 1``."""
    B, S = shape.global_batch, shape.seq_len
    params_sds = params_specs(cfg)
    cache_sds = api.init_decode_caches(cfg, B, S, device="meta")
    tok_sds = torch.empty((B, 1), dtype=torch.int32, device="meta")

    @torch.inference_mode()
    def serve_step(model, token, pos: int, caches):
        return api.decode_step(model, token, pos, caches, cfg)

    return serve_step, (params_sds, tok_sds, S - 1, cache_sds)


def make_step(cfg: ModelConfig, shape: InputShape):
    """Dispatch by shape kind. Returns (fn, example_args).

    Env flags, as in the JAX package: REPRO_MOMENTS_BF16=1 uses bf16
    optimizer moments; REPRO_GRAD_ACCUM=n sets the microbatch count;
    REPRO_ZERO_POD=1 (moments sharded across pods) raises
    NotImplementedError until the sharding slice."""
    kw = {}
    if os.environ.get("REPRO_MOMENTS_BF16", "0") == "1":
        kw["moments_dtype"] = torch.bfloat16
    if os.environ.get("REPRO_ZERO_POD", "0") == "1":
        kw["zero_pod"] = True
    if os.environ.get("REPRO_GRAD_ACCUM"):
        kw["grad_accum"] = int(os.environ["REPRO_GRAD_ACCUM"])
    if shape.kind == "train":
        return make_train_step(cfg, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape)
    return make_serve_step(cfg, shape)
