"""Common layers: RMSNorm, rotary embeddings, gated MLP, initializers.

What each function computes is that of ``repro.models.layers``, including
its conventions: RMSNorm scales by ``1 + gamma`` (zero-centred weights),
rope rotates interleaved pairs ``x[0::2]``, ``x[1::2]`` over the first
``int(Dh * pct) // 2 * 2`` dims, and the MLP applies SiLU in fp32 before
casting back and gating. ``remat`` is the JAX package's
``jax.checkpoint`` of a layer under ``cfg.remat``.
"""
from __future__ import annotations

import zlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.context import batch_sharded


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
class Maker:
    """Makes named parameters on ``device``: each is drawn from its own
    ``torch.Generator`` seeded by ``seed`` and ``crc32(name)``, so a
    parameter's values do not depend on the order of construction. The
    distributions are the JAX package's (truncated normal at 2 sigma
    scaled by 1/sqrt(fan_in); 0.02 * N(0, 1) for embeddings); the bits are
    torch's, not JAX's. Parameters need no grad (serving); training turns
    it on (``model.requires_grad_()``). On the ``meta`` device they are
    shapes and dtypes only, the step builders' example arguments."""

    def __init__(self, seed: int, dtype: torch.dtype, device):
        self.seed = seed
        self.dtype = dtype
        self.device = torch.device(device)

    def _generator(self, name: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed << 32) + zlib.crc32(name.encode()))
        return g

    def __call__(self, name: str, shape, kind: str = "dense",
                 scale: float = 1.0) -> nn.Parameter:
        shape = tuple(shape)
        if kind not in ("zeros", "ones", "dense", "embed"):
            raise ValueError(kind)
        if self.device.type == "meta":
            w = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif kind == "zeros":
            w = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif kind == "ones":
            w = torch.ones(shape, dtype=self.dtype, device=self.device)
        else:
            w = torch.empty(shape, dtype=torch.float32, device=self.device)
            g = self._generator(name)
            if kind == "dense":
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                w.mul_(scale / fan_in ** 0.5)
            else:
                w.normal_(0.0, 1.0, generator=g).mul_(0.02)
            w = w.to(self.dtype)
        return nn.Parameter(w, requires_grad=False)


def _records(args) -> bool:
    """Whether autograd records a call on ``args``: grad is enabled and a
    tensor, or a parameter of a module, among them requires grad."""
    return torch.is_grad_enabled() and any(
        a.requires_grad if isinstance(a, torch.Tensor) else
        isinstance(a, nn.Module) and any(p.requires_grad
                                         for p in a.parameters())
        for a in args)


def remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat`` is
    set and autograd records: its activations are dropped after the
    forward and recomputed in the backward, as ``jax.checkpoint`` does in
    the JAX package (its places: each layer or block of the forward)."""
    return recompute(fn, *args) if cfg.remat else fn(*args)


def recompute(fn, *args):
    """``fn(*args)``, checkpointed where autograd records, whatever the
    config (the places the JAX package wraps in ``jax.checkpoint``
    unconditionally, such as MLA's query blocks)."""
    if _records(args):
        # no random op runs inside a layer: no RNG state to replay
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (partial rotation supported)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, rotary_pct: float, theta: float, device):
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float64,
                        device=device) / rot_dim
    return rot_dim, (1.0 / theta ** exps).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rotary_pct: float,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    rot_dim, inv = rope_freqs(x.shape[-1], rotary_pct, theta, x.device)
    if rot_dim == 0:
        return x
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    ang = positions[..., None].float() * inv              # [..., S, rot/2]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, rot/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """w_gate, w_up: [D, F]; w_down: [F, D] (the JAX shapes)."""

    def __init__(self, make: Maker, d_model: int, d_ff: int,
                 prefix: str = ""):
        super().__init__()
        self.w_gate = make(prefix + "w_gate", (d_model, d_ff))
        self.w_up = make(prefix + "w_up", (d_model, d_ff))
        self.w_down = make(prefix + "w_down", (d_ff, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    g = x @ p.w_gate
    u = x @ p.w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return batch_sharded(h @ p.w_down)
