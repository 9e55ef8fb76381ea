"""Step builders (``repro.launch.steps``): train_step / prefill_step /
serve_step as functions with example arguments and placements per
(architecture x input shape x mesh).

Each builder returns ``(fn, example_args)``. The example arguments are
``device="meta"`` tensors (the model built on the meta device, its
optimizer state, the batch and labels), the counterpart of the JAX
package's ``ShapeDtypeStruct``s: shapes and dtypes, never allocated.
PyTorch runs eagerly, so ``fn`` is the step itself, not a compiled
program. It runs under ``mesh_context(mesh)``: it makes the parameters
(in place), the optimizer moments and its inputs ``DTensor``s placed by
``repro_torch.sharding.specs`` (the JAX package's ``in_shardings``), and
places its outputs by them (its ``out_shardings``). A plain tensor an
op meets there counts as replicated (``implicit_replication``). The
batch is counted in shards: ``default_grad_accum`` divides it over the
mesh's batch axes. ``mesh=None`` (which the JAX package does not take)
builds the un-meshed step: plain tensors, no context, as serving runs.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any

import torch

from repro_torch.config import ENCDEC, VLM, InputShape, ModelConfig
from repro_torch.models import api
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.sharding import specs as sh
from repro_torch.sharding.context import axis_names, axis_size, mesh_context


@contextlib.contextmanager
def meshed(mesh):
    """The context a step runs in: the mesh set for model code, and plain
    tensors (positions, masks, the learning rate) taken as replicated.
    With no mesh, nothing."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with mesh_context(mesh), implicit_replication():
        yield


def _no_grad(mesh):
    """``inference_mode`` un-meshed (as serving runs); ``no_grad`` under a
    mesh, since DTensor's view ops fail under ``inference_mode`` (a
    reshape of a parameter cannot set an inference tensor's version
    counter; ``unflatten`` checks its sizes against the local shard)."""
    return torch.inference_mode() if mesh is None else torch.no_grad()


def _place(tree, mesh, spec):
    return tree if mesh is None else sh.place(tree, mesh, spec)


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


def batch_in_specs(cfg: ModelConfig, mesh, B: int):
    if cfg.family in (ENCDEC, VLM):
        return (sh.embeds_spec(mesh, B), sh.token_spec(mesh, B))
    return sh.token_spec(mesh, B)


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


def default_grad_accum(cfg: ModelConfig, mesh, shape: InputShape) -> int:
    """Microbatch count: smallest power-of-2 A such that the per-device
    layer-boundary residuals (L x (B/shards/A) x S x D x 2B) fit the
    activation budget, with (B/A) still divisible by the batch shards."""
    B, S = shape.global_batch, shape.seq_len
    nsh = 1
    for a in ("pod", "data"):
        if mesh is not None and a in axis_names(mesh):
            nsh *= axis_size(mesh, a)
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


def _place_model(model, mesh, p_spec) -> None:
    """Make the model's plain parameters ``DTensor``s placed by
    ``p_spec``, in place (nothing with no mesh)."""
    if mesh is not None:
        sh.shard_model(model, mesh, p_spec)


def _plain(x):
    """A replicated metric as a plain tensor."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _loss_and_grads(cfg, mesh, model, names, params, batch, labels):
    """The loss through ``api.forward`` and ``api.loss_fn`` and its
    gradients, each placed as its parameter under a mesh."""
    logits, aux = api.forward(model, batch, cfg)
    loss = api.loss_fn(logits, labels[:, :logits.shape[1]], aux)
    grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, params)]
    return loss.detach(), dict(zip(names, grads))


def loss_and_grads(cfg: ModelConfig, mesh, model, batch, labels):
    """(loss, name -> gradient) of one batch, as ``make_train_step``'s
    step computes them before its update: under ``mesh`` (the parameters
    and inputs placed by the specs), or un-meshed with None. The model's
    parameters must require grad."""
    B = labels.shape[0]
    if mesh is not None:
        _place_model(model, mesh, sh.param_specs(model, mesh))
    with meshed(mesh):
        batch = _place(batch, mesh, None if mesh is None else
                       batch_in_specs(cfg, mesh, B))
        labels = _place(labels, mesh, None if mesh is None else
                        sh.token_spec(mesh, B))
        names, params = zip(*model.named_parameters())
        return _loss_and_grads(cfg, mesh, model, names, params, batch,
                               labels)


def make_train_step(cfg: ModelConfig, mesh, shape: InputShape,
                    grad_accum: int = 0, moments_dtype=None,
                    zero_pod: bool = False):
    """``fn(model, opt_state, batch, labels) -> (model, opt_state,
    metrics)``: loss and gradients through ``api.forward`` and
    ``api.loss_fn`` (A microbatches, each constrained batch-sharded: the
    gradients ``g / A`` accumulated in each parameter's dtype, the mean of
    the losses), each gradient placed as its parameter, then
    ``adamw_update``, in place. ``fn.specs`` holds the specs it places
    its arguments by (None without a mesh). The model's parameters must
    require grad.
    ``moments_dtype`` / ``zero_pod``: bf16 optimizer moments, and the
    moments sharded across the ``pod`` axis (ZeRO; pods are otherwise
    pure data-parallel replicas of the optimizer state). The metrics are
    plain (replicated) tensors."""
    B, S = shape.global_batch, shape.seq_len
    A = grad_accum or default_grad_accum(cfg, mesh, shape)
    if B % A:
        raise ValueError(f"batch {B} does not split into {A} microbatches")
    params_sds = params_specs(cfg)
    opt_sds = adamw_init(dict(params_sds.named_parameters()),
                         moments_dtype=moments_dtype or torch.float32)
    batch_sds = batch_specs(cfg, B, S)
    lbl_sds = label_specs(cfg, B, S)
    p_spec = o_spec = b_spec = l_spec = None
    if mesh is not None:
        p_spec = sh.param_specs(params_sds, mesh)
        o_spec = sh.opt_specs(opt_sds, p_spec)
        if zero_pod and "pod" in axis_names(mesh):
            o_spec = sh.opt_specs(opt_sds, p_spec, zero_axis="pod",
                                  params=params_sds, mesh=mesh)
        b_spec = batch_in_specs(cfg, mesh, B)
        l_spec = sh.token_spec(mesh, B)

    def loss_and_grads(model, names, params, batch, labels):
        return _loss_and_grads(cfg, mesh, model, names, params, batch,
                               labels)

    def constrain_mb(x):
        from repro_torch.sharding.context import constrain
        return constrain(x, "batch", *(None,) * (x.ndim - 1))

    def train_step(model, opt_state, batch, labels):
        _place_model(model, mesh, p_spec)
        with meshed(mesh):
            if mesh is not None:
                opt_state = sh.shard_opt_state(opt_state, mesh, o_spec)
            batch = _place(batch, mesh, b_spec)
            labels = _place(labels, mesh, l_spec)
            names, params = zip(*model.named_parameters())
            if A == 1:
                lval, grads = loss_and_grads(model, names, params, batch,
                                             labels)
            else:
                grads = {n: torch.zeros_like(p)
                         for n, p in zip(names, params)}
                lvals = []
                mbs = [tuple(map(constrain_mb, b)) if isinstance(b, tuple)
                       else constrain_mb(b) for b in _split_micro(batch, A)]
                mls = [constrain_mb(lab) for lab in _split_micro(labels, A)]
                for b, lab in zip(mbs, mls):
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
            metrics = {k: _plain(v) for k, v in metrics.items()}
        return model, new_opt, metrics

    train_step.specs = {"params": p_spec, "opt": o_spec, "batch": b_spec,
                        "labels": l_spec}
    return train_step, (params_sds, opt_sds, batch_sds, lbl_sds)


# ---------------------------------------------------------------------------
# prefill_step
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                      extra_capacity: int = 0):
    """``fn(model, batch) -> (last-position logits, caches)``: ``api.prefill``
    under ``_no_grad``, the logits and caches placed by their specs.
    ``extra_capacity`` (which the JAX package's ``make_prefill_step``
    lacks) sizes the caches that many slots past the prompt, as
    ``api.prefill`` takes it, for a serve step whose shape counts the
    decoded tokens too."""
    B, S = shape.global_batch, shape.seq_len
    params_sds = params_specs(cfg)
    batch_sds = batch_specs(cfg, B, S)
    p_spec = b_spec = c_spec = lg_spec = None
    if mesh is not None:
        p_spec = sh.param_specs(params_sds, mesh)
        b_spec = batch_in_specs(cfg, mesh, B)
        cache_sds = api.init_decode_caches(cfg, B, S + extra_capacity,
                                           device="meta")
        c_spec = sh.cache_specs(cfg, cache_sds, mesh, B)
        lg_spec = sh.logits_spec(mesh, B, cfg.vocab_size)

    def prefill_step(model, batch):
        _place_model(model, mesh, p_spec)
        with _no_grad(mesh), meshed(mesh):
            batch = _place(batch, mesh, b_spec)
            logits, caches = api.prefill(model, batch, cfg,
                                         extra_capacity=extra_capacity)
            return (_place(logits, mesh, lg_spec),
                    _place(caches, mesh, c_spec))

    prefill_step.specs = {"params": p_spec, "batch": b_spec,
                          "caches": c_spec, "logits": lg_spec}
    return prefill_step, (params_sds, batch_sds)


# ---------------------------------------------------------------------------
# serve_step (decode): ONE token with a KV cache of seq_len
# ---------------------------------------------------------------------------
def make_serve_step(cfg: ModelConfig, mesh, shape: InputShape):
    """``fn(model, token, pos, caches) -> (logits, caches)``:
    ``api.decode_step`` under ``_no_grad``, the token, caches
    and logits placed by their specs. The port's decode step takes its
    position as a host int (no layer reads it back from the card), so the
    example position is the int ``S - 1``."""
    B, S = shape.global_batch, shape.seq_len
    params_sds = params_specs(cfg)
    cache_sds = api.init_decode_caches(cfg, B, S, device="meta")
    p_spec = c_spec = t_spec = lg_spec = None
    if mesh is not None:
        p_spec = sh.param_specs(params_sds, mesh)
        c_spec = sh.cache_specs(cfg, cache_sds, mesh, B)
        t_spec = sh.token_spec(mesh, B)
        lg_spec = sh.logits_spec(mesh, B, cfg.vocab_size)
    tok_sds = torch.empty((B, 1), dtype=torch.int32, device="meta")

    def serve_step(model, token, pos: int, caches):
        _place_model(model, mesh, p_spec)
        with _no_grad(mesh), meshed(mesh):
            token = _place(token, mesh, t_spec)
            caches = _place(caches, mesh, c_spec)
            logits, caches = api.decode_step(model, token, pos, caches, cfg)
            return (_place(logits, mesh, lg_spec),
                    _place(caches, mesh, c_spec))

    serve_step.specs = {"params": p_spec, "token": t_spec, "caches": c_spec,
                        "logits": lg_spec}
    return serve_step, (params_sds, tok_sds, S - 1, cache_sds)


def make_step(cfg: ModelConfig, mesh, shape: InputShape):
    """Dispatch by shape kind. Returns (fn, example_args).

    Env flags, as in the JAX package: REPRO_MOMENTS_BF16=1 uses bf16
    optimizer moments; REPRO_ZERO_POD=1 shards moments across pods;
    REPRO_GRAD_ACCUM=n sets the microbatch count."""
    kw = {}
    if os.environ.get("REPRO_MOMENTS_BF16", "0") == "1":
        kw["moments_dtype"] = torch.bfloat16
    if os.environ.get("REPRO_ZERO_POD", "0") == "1":
        kw["zero_pod"] = True
    if os.environ.get("REPRO_GRAD_ACCUM"):
        kw["grad_accum"] = int(os.environ["REPRO_GRAD_ACCUM"])
    with mesh_context(mesh):
        if shape.kind == "train":
            return make_train_step(cfg, mesh, shape, **kw)
        if shape.kind == "prefill":
            return make_prefill_step(cfg, mesh, shape)
        return make_serve_step(cfg, mesh, shape)
