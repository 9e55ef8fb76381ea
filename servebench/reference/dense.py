"""Plain float32 reference of the dense decoder LM as the configuration
runs it (stablelm-2-1.6b, h2o-danube3-4b, qwen3-4b).

Written from the equations, not from the program: it imports nothing of
the program and reads only the configuration (a dict of the port's
``ModelConfig`` fields) and the weights the benchmark made.

    x = embed[tokens]
    per layer:  h = norm(x, ln1);  x += attn(h);  h = norm(x, ln2)
                x += (silu(h W_gate) * (h W_up)) W_down
    logits = norm(x, final_norm) @ lm_head   (embed^T when tied)

norm(x, g) = x / sqrt(mean(x^2) + eps) * (1 + g) (RMSNorm with a
zero-centred gain). Attention: q, k, v = h W_q, h W_k, h W_v per head;
with qk-norm, q and k are RMS-normed per head before rotation; the first
``int(Dh * rotary_pct) // 2 * 2`` dims of q and k are rotated as
consecutive pairs (2i, 2i+1) at angle pos * theta^(-2i/rot); query head h
reads kv head h // (H / Kh); causal, and with a window w a query at t sees
keys t - w < s <= t; softmax of q.k / sqrt(Dh).

Parameter names and shapes are those the port's modules hold, so the
benchmark can load the same tensors into both.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from servebench.reference.arith import Arith

#: the gains of the norms are drawn N(0, NORM_STD) (the norm scales by 1 + g)
NORM_STD = 0.1


def head_dim(cfg: dict) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, tuple]]:
    """(name, shape, kind, args) of every parameter; kind "normal" draws
    N(args[0], args[1])."""
    D, H, Kh, Fd, V = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                       cfg["d_ff"], cfg["vocab_size"])
    Dh = head_dim(cfg)
    norm = ("normal", (0.0, NORM_STD))

    def dense(fan_in):
        return ("normal", (0.0, 1.0 / math.sqrt(fan_in)))
    specs = [("embed", (V, D)) + dense(D)]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        specs += [(p + "ln1", (D,)) + norm,
                  (p + "attn.wq", (D, H, Dh)) + dense(D),
                  (p + "attn.wk", (D, Kh, Dh)) + dense(D),
                  (p + "attn.wv", (D, Kh, Dh)) + dense(D),
                  (p + "attn.wo", (H, Dh, D)) + dense(H * Dh)]
        if cfg["qk_norm"]:
            specs += [(p + "attn.q_norm", (Dh,)) + norm,
                      (p + "attn.k_norm", (Dh,)) + norm]
        specs += [(p + "ln2", (D,)) + norm,
                  (p + "mlp.w_gate", (D, Fd)) + dense(D),
                  (p + "mlp.w_up", (D, Fd)) + dense(D),
                  (p + "mlp.w_down", (Fd, D)) + dense(Fd)]
    specs.append(("final_norm", (D,)) + norm)
    if not cfg["tie_embeddings"]:
        specs.append(("lm_head", (D, V)) + dense(D))
    return specs


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + g)


def rotate(x: torch.Tensor, theta: float, pct: float) -> torch.Tensor:
    """x [B, S, H, Dh] at positions 0..S-1, pairs (2i, 2i+1) of the first
    rot dims turned as complex numbers."""
    B, S, H, Dh = x.shape
    rot = int(Dh * pct) // 2 * 2
    if rot == 0:
        return x
    pos = torch.arange(S, dtype=torch.float64, device=x.device)
    inv = theta ** (-torch.arange(0, rot, 2, dtype=torch.float64,
                                  device=x.device) / rot)
    ang = pos[:, None] * inv[None, :]
    turn = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    pairs = torch.view_as_complex(
        x[..., :rot].reshape(B, S, H, rot // 2, 2).contiguous())
    turned = torch.view_as_real(pairs * turn[None, :, None, :])
    return torch.cat([turned.reshape(B, S, H, rot), x[..., rot:]], dim=-1)


def attend(q, k, v, window, arith: Arith):
    """q [B, S, H, Dh]; k, v [B, S, Kh, Dh] -> [B, S, H, Dh]."""
    B, S, H, Dh = q.shape
    Kh = k.shape[2]
    G = H // Kh
    t = torch.arange(S, device=q.device)
    allowed = t[None, :] <= t[:, None]
    if window is not None:
        allowed &= (t[:, None] - t[None, :]) < window
    out = torch.empty_like(q)
    for b in range(B):
        for j in range(Kh):
            qs = q[b, :, j * G:(j + 1) * G].transpose(0, 1)        # [G, S, Dh]
            s = arith.mm(qs, k[b, :, j].T) / math.sqrt(Dh)          # [G, S, S]
            p = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
            out[b, :, j * G:(j + 1) * G] = arith.mm(
                p, v[b, :, j]).transpose(0, 1)
    return out


def logits(w: Callable[[str], torch.Tensor], tokens: torch.Tensor,
           cfg: dict, arith: Arith) -> torch.Tensor:
    """tokens [B, S] -> float32 logits [B, S, V]; ``w(name)`` gives a
    parameter as float32, so only one layer's weights are upcast at once."""
    B, S = tokens.shape
    D, H, Kh = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    Dh, eps = head_dim(cfg), cfg["norm_eps"]
    x = w("embed")[tokens.long()]
    for i in range(cfg["num_layers"]):
        def p(name):
            return w(f"layers.{i}.{name}")
        h = rms_norm(x, p("ln1"), eps)
        q = arith.mm(h, p("attn.wq").reshape(D, H * Dh)).reshape(B, S, H, Dh)
        k = arith.mm(h, p("attn.wk").reshape(D, Kh * Dh)).reshape(B, S, Kh,
                                                                  Dh)
        v = arith.mm(h, p("attn.wv").reshape(D, Kh * Dh)).reshape(B, S, Kh,
                                                                  Dh)
        if cfg["qk_norm"]:
            q = rms_norm(q, p("attn.q_norm"), eps)
            k = rms_norm(k, p("attn.k_norm"), eps)
        q = rotate(q, cfg["rope_theta"], cfg["rotary_pct"])
        k = rotate(k, cfg["rope_theta"], cfg["rotary_pct"])
        o = attend(q, k, v, cfg["sliding_window"], arith)
        x = x + arith.mm(o.reshape(B, S, H * Dh),
                         p("attn.wo").reshape(H * Dh, D))
        h = rms_norm(x, p("ln2"), eps)
        gate = F.silu(arith.mm(h, p("mlp.w_gate")))
        x = x + arith.mm(gate * arith.mm(h, p("mlp.w_up")), p("mlp.w_down"))
    x = rms_norm(x, w("final_norm"), eps)
    head = w("embed").T if cfg["tie_embeddings"] else w("lm_head")
    return arith.mm(x, head)

