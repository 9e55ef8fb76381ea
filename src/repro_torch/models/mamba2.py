"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) decoder LM:
``repro.models.mamba2`` as PyTorch modules.

The chunked SSD algorithm: a within-chunk quadratic ("attention-like")
term plus an inter-chunk linear recurrence over chunk states, run as a
loop over chunks with an fp32 carry, so the quadratic tensors exist for
one chunk at a time. Decode is a single O(1)-state update. The JAX
package has no Pallas kernel for the scan, so it runs on torch ops here.

Parameters keep the JAX names and shapes; the state-dict key of a
parameter is its JAX tree path with the layer stack split into
``layers.<i>`` (``repro_torch.bridge``). Embeddings are tied, so there is
no ``lm_head``. The recurrentgemma hybrid's rec blocks also use
``_causal_conv``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.config import SSM, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Maker, remat, rms_norm, torch_dtype
from repro_torch.sharding import context as shctx
from repro_torch.sharding.context import batch_sharded, constrain


class SSMCache(NamedTuple):
    state: torch.Tensor     # [B, H, P, N] fp32
    conv_x: torch.Tensor    # [B, K-1, d_inner]
    conv_B: torch.Tensor    # [B, K-1, N]
    conv_C: torch.Tensor    # [B, K-1, N]


class Mamba2Layer(nn.Module):
    """SSD mixer: ln, w_z, w_x, w_B, w_C, w_dt, conv_x, conv_B, conv_C,
    A_log, dt_bias, D_skip, out_norm, w_out (the JAX shapes)."""

    def __init__(self, make: Maker, cfg: ModelConfig, prefix: str = ""):
        super().__init__()
        D, W = cfg.d_model, cfg.ssm_d_inner
        N, H, K = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
        self.ln = make(prefix + "ln", (D,), "zeros")
        self.w_z = make(prefix + "w_z", (D, W))
        self.w_x = make(prefix + "w_x", (D, W))
        self.w_B = make(prefix + "w_B", (D, N))
        self.w_C = make(prefix + "w_C", (D, N))
        self.w_dt = make(prefix + "w_dt", (D, H))
        self.conv_x = make(prefix + "conv_x", (K, W), scale=0.5)
        self.conv_B = make(prefix + "conv_B", (K, N), scale=0.5)
        self.conv_C = make(prefix + "conv_C", (K, N), scale=0.5)
        self.A_log = make(prefix + "A_log", (H,), "zeros")
        self.dt_bias = make(prefix + "dt_bias", (H,), "zeros")
        self.D_skip = make(prefix + "D_skip", (H,), "zeros")
        self.out_norm = make(prefix + "out_norm", (W,), "zeros")
        self.w_out = make(prefix + "w_out", (W, D))


def layer_build(make: Maker, cfg: ModelConfig, index: int) -> Mamba2Layer:
    return Mamba2Layer(make, cfg, prefix=f"layers.{index}.")


class Mamba2(nn.Module):
    """embed [V, D], layers.<i> (Mamba2Layer), final_norm [D], lm_head
    [D, V] (absent with tied embeddings)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family != SSM:
            raise ValueError(f"{cfg.name} is not an SSM model")
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


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Mamba2:
    """Random weights from ``seed``, made on ``device``."""
    return Mamba2(cfg, seed, device)


# ---------------------------------------------------------------------------
# Mixer
# ---------------------------------------------------------------------------
def _chunks(t, nc: int, Lc: int):
    """[B, S, ...] -> [B, nc, Lc, ...] (a reshape: a DTensor under
    ``inference_mode`` checks ``unflatten``'s sizes against its shard)."""
    return t.reshape(t.shape[0], nc, Lc, *t.shape[2:])


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 buf: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B,S,F], w: [K,F]. buf: [B,K-1,F] history.

    Returns (y [B,S,F], new_buf [B,K-1,F]). y_t = sum_k w[k] * xp[t + k]
    over the history-padded input xp, summed in x's dtype in the order
    k = 0..K-1, as the JAX package does.
    """
    K = w.shape[0]
    if buf is None:
        buf = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    xp = torch.cat([buf.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for k in range(K):
        y = y + xp[:, k:k + S] * w[k]
    new_buf = xp[:, -(K - 1):] if K > 1 else buf
    return y, new_buf


def _ssd_chunked(xh, dt, A, B_, C_, chunk: int):
    """SSD scan. xh: [B,S,H,P]; dt: [B,S,H]; A: [H]; B_/C_: [B,S,N].

    Loops over chunks of ``min(chunk, S)`` tokens, which must divide S,
    carrying the fp32 state h [B,H,P,N], so the quadratic tensors exist
    for one chunk at a time. They are laid out [B,H,l,m], so every
    elementwise op runs along contiguous rows, and every three-operand
    product is a batched matrix product per (b, h); none makes a
    [B,Lc,Lc,H,P] tensor. Computes in fp32.

    Returns (y [B,S,H,P] in xh's dtype, final_state [B,H,P,N] fp32).
    """
    Bb, S, H, Pd = xh.shape
    N = B_.shape[-1]
    Lc = min(chunk, S)
    if S % Lc:
        raise AssertionError((S, Lc))
    # under a mesh: batch and heads sharded, the sequence whole (the
    # chunks split it); the scan then runs on each rank's shards
    xh = constrain(xh, "batch", None, "model", None)
    dt = constrain(dt, "batch", None, "model")
    B_ = constrain(B_, "batch", None, None)
    C_ = constrain(C_, "batch", None, None)
    if isinstance(xh, DTensor):
        return _ssd_on_shards(xh, dt, A, B_, C_, chunk)
    nc = S // Lc
    xs = _chunks(xh.float(), nc, Lc).permute(1, 0, 3, 2, 4)
    dts = _chunks(dt.float(), nc, Lc).permute(1, 0, 3, 2)
    Bs = _chunks(B_.float(), nc, Lc).transpose(0, 1)
    Cs = _chunks(C_.float(), nc, Lc).transpose(0, 1)
    above = ~torch.ones((Lc, Lc), dtype=torch.bool, device=xh.device).tril()
    h = torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        # one chunk: x [B,H,Lc,P], dt [B,H,Lc], B and C [B,Lc,N]
        x_c, dt_c, B_c, C_c = xs[c], dts[c], Bs[c], Cs[c]
        seg = torch.cumsum(dt_c * A[:, None], dim=-1)  # [B,H,Lc] (negative)
        total = seg[..., -1]                           # [B,H]
        # within-chunk decay L[l,m] = exp(seg_l - seg_m) * dt_m, m <= l;
        # masked before exp, which would overflow above the diagonal
        Lmat = (seg[..., :, None] - seg[..., None, :]).masked_fill_(
            above, float("-inf"))
        att = C_c @ B_c.transpose(1, 2)                # [B,l,m]
        # "blm,blmh,bmhp->blhp": [l,m] x [m,p] per (b, h), the products
        # in the same order either way. Autograd keeps exp's output and
        # the products' operands, so where it records it gets new
        # tensors; elsewhere one [B,H,l,m] buffer is reused, which stays
        # in L2 (out of place, mamba2-2.7b's prefill at B2 S2048 took
        # 4.5 % longer on an H100)
        if Lmat.requires_grad or att.requires_grad:
            Lmat = Lmat.exp() * dt_c[..., None, :] * att[:, None]
        else:
            Lmat = Lmat.exp_().mul_(dt_c[..., None, :]).mul_(att[:, None])
        y = Lmat @ x_c                                 # [B,H,l,P]
        # contribution of the carried state: "bln,bhpn,blh->blhp"
        y += (C_c[:, None] @ h.transpose(-1, -2)) * seg.exp()[..., None]
        # chunk state + recurrence: "blh,bln,blhp->bhpn"
        decay_to_end = torch.exp(total[..., None] - seg) * dt_c  # [B,H,Lc]
        s_c = (x_c * decay_to_end[..., None]).transpose(-1, -2) @ B_c[:, None]
        h = h * torch.exp(total)[..., None, None] + s_c
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2).to(xh.dtype)   # [B,S,H,P]
    return y, h


def _ssd_on_shards(xh, dt, A, B_, C_, chunk: int):
    """``_ssd_chunked`` under a mesh, on the local shards: the scan is
    independent per (batch row, head), so each rank scans its batch rows
    and heads with plain tensors (DTensor's dispatch of every op of the
    chunk loop would cost more than the scan). B and C, replicated over
    the heads' axis, get a partial-sum gradient over it, and A over the
    batch axes."""
    mesh = xh.device_mesh
    heads = [isinstance(p, Shard) and p.dim == 2 for p in xh.placements]
    batch = [isinstance(p, Shard) and p.dim == 0 for p in xh.placements]

    def pl(on_heads, on_batch, other=Replicate()):
        return [on_heads if h else on_batch if b else other
                for h, b in zip(heads, batch)]
    xl = xh.to_local()
    dtl = dt.redistribute(mesh, pl(Shard(2), Shard(0))).to_local()
    # A [H] is shared by the batch rows: its gradient is a partial sum
    # over the batch shards
    Al = A.redistribute(mesh, pl(Shard(0), Replicate())).to_local(
        grad_placements=pl(Shard(0), Partial())) \
        if isinstance(A, DTensor) else A
    bc_in, bc_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
    Bl = B_.redistribute(mesh, bc_in).to_local(grad_placements=bc_grad)
    Cl = C_.redistribute(mesh, bc_in).to_local(grad_placements=bc_grad)
    y, h = _ssd_chunked(xl, dtl, Al, Bl, Cl, chunk)
    return (DTensor.from_local(y, mesh, pl(Shard(2), Shard(0)),
                               run_check=False),
            DTensor.from_local(h, mesh, pl(Shard(1), Shard(0)),
                               run_check=False))


def _gated_out(lp: Mamba2Layer, y, z, x_in, cfg: ModelConfig):
    """y, x_in: [B,S,H,P]; z: [B,S,W]."""
    y = y + x_in * lp.D_skip[..., None]                # skip connection
    y = y.flatten(2)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y, lp.out_norm, cfg.norm_eps)
    return batch_sharded(y @ lp.w_out)


def _mixer_inputs(lp: Mamba2Layer, x, cfg: ModelConfig,
                  cache: Optional[SSMCache]):
    """Norm, the five input projections, the causal convs and their
    SiLU, dt (fp32, softplus) and A (fp32). Returns (z, xi, Bi, Ci, dt, A,
    conv buffers)."""
    h = rms_norm(x, lp.ln, cfg.norm_eps)
    z = h @ lp.w_z
    xi = h @ lp.w_x
    Bi = h @ lp.w_B
    Ci = h @ lp.w_C
    dt = h @ lp.w_dt
    bufs = (None, None, None) if cache is None else (
        cache.conv_x, cache.conv_B, cache.conv_C)
    xi, bx = _causal_conv(xi, lp.conv_x, bufs[0])
    Bi, bB = _causal_conv(Bi, lp.conv_B, bufs[1])
    Ci, bC = _causal_conv(Ci, lp.conv_C, bufs[2])
    xi = F.silu(xi.float()).to(xi.dtype)
    Bi = F.silu(Bi.float()).to(Bi.dtype)
    Ci = F.silu(Ci.float()).to(Ci.dtype)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where log1p(exp(-x)) < 2.1e-9 is below fp32's resolution there
    dt = F.softplus(dt.float() + lp.dt_bias.float())
    A = -torch.exp(lp.A_log.float())
    return z, xi, Bi, Ci, dt, A, (bx, bB, bC)


def layer_apply(lp: Mamba2Layer, x, cfg: ModelConfig,
                cache: Optional[SSMCache] = None,
                return_cache: bool = False):
    """Full-sequence SSD mixer. x: [B,S,D]."""
    Bb, S, _ = x.shape
    H, Pd = cfg.ssm_nheads, cfg.ssm_headdim
    z, xi, Bi, Ci, dt, A, (bx, bB, bC) = _mixer_inputs(lp, x, cfg, cache)
    xh = xi.reshape(Bb, S, H, Pd)
    y, hT = _ssd_chunked(xh, dt, A, Bi, Ci, cfg.ssm_chunk)
    x = x + _gated_out(lp, y, z, xh, cfg)
    if return_cache:
        # copies, so the cache does not hold the [B, S, ·] conv inputs
        return x, SSMCache(hT, bx.clone(), bB.clone(), bC.clone())
    return x


def layer_decode(lp: Mamba2Layer, x, cache: SSMCache, cfg: ModelConfig):
    """One token. x: [B,1,D]. The state is updated in fp32."""
    Bb = x.shape[0]
    H, Pd = cfg.ssm_nheads, cfg.ssm_headdim
    z, xi, Bi, Ci, dt, A, (bx, bB, bC) = _mixer_inputs(lp, x, cfg, cache)
    dt = dt[:, 0]                                      # [B,H]
    xh = xi.reshape(Bb, H, Pd).float()
    g = torch.exp(dt * A)                              # [B,H]
    upd = (dt[:, :, None, None] * Bi[:, 0].float()[:, None, None, :]
           * xh[..., None])                            # "bh,bn,bhp->bhpn"
    state = cache.state * g[:, :, None, None] + upd
    y = (state @ Ci[:, 0].float()[:, None, :, None]).squeeze(-1)  # [B,H,P]
    y = y[:, None].to(x.dtype)                         # [B,1,H,P]
    out = _gated_out(lp, y, z, xh[:, None].to(x.dtype), cfg)
    return x + out, SSMCache(state, bx, bB, bC)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
def forward(model: Mamba2, tokens, cfg: ModelConfig):
    """tokens: [B, S] int32 -> logits [B, S, V]. Each layer is
    checkpointed under ``cfg.remat`` when autograd records."""
    x = tfm.embed_tokens(model, tokens, cfg)
    for lp in model.layers:
        x = remat(cfg, layer_apply, lp, x, cfg)
    return tfm.unembed(model, x, cfg)


def prefill(model: Mamba2, tokens, cfg: ModelConfig,
            extra_capacity: int = 0):
    """Returns (last-position logits [B, 1, V], one SSMCache per layer).
    The state does not grow with the sequence: ``extra_capacity`` is
    unused."""
    x = tfm.embed_tokens(model, tokens, cfg)
    caches = []
    for lp in model.layers:
        x, cache = layer_apply(lp, x, cfg, return_cache=True)
        caches.append(cache)
    return tfm.unembed(model, x[:, -1:, :], cfg), caches


def decode_step(model: Mamba2, token, pos: int, caches, cfg: ModelConfig):
    """token: [B, 1] int32. The SSM state is position-free: ``pos`` is
    unused. -> (logits [B, 1, V], new caches)."""
    del pos
    x = tfm.embed_tokens(model, token, cfg)
    new_caches = []
    for lp, cache in zip(model.layers, caches):
        x, cache = layer_decode(lp, x, cache, cfg)
        new_caches.append(cache)
    return tfm.unembed(model, x, cfg), new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int,
                       device="cuda"):
    """Zero caches, one per layer (the JAX package stacks them over
    layers); their size does not depend on ``seq_len``."""
    del seq_len
    H, Pd, N, K, W = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                      cfg.ssm_conv, cfg.ssm_d_inner)
    dt = torch_dtype(cfg.dtype)

    def zeros(shape, dtype, *spec):
        return shctx.zeros(shape, dtype, device, *spec)
    return [SSMCache(state=zeros((batch, H, Pd, N), torch.float32, "batch",
                                 "model", None, None),
                     conv_x=zeros((batch, K - 1, W), dt, "batch", None,
                                  "model"),
                     conv_B=zeros((batch, K - 1, N), dt, "batch", None, None),
                     conv_C=zeros((batch, K - 1, N), dt, "batch", None, None))
            for _ in range(cfg.num_layers)]
