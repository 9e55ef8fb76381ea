"""Plain float32 reference of the Mamba-2 LM as the configuration runs it
(state-spaces/mamba2-2.7b).

Written from the equations of arXiv:2405.21060 in their quadratic
("attention-like") form over the whole sequence, where the program runs
the chunked scan; it imports nothing of the program.

    x = embed[tokens]
    per layer:  h = norm(x, ln)
                z, u, B, C, dt0 = h W_z, h W_x, h W_B, h W_C, h W_dt
                u, B, C = silu(causal depthwise conv(·))   (K taps, no bias)
                dt = softplus(dt0 + dt_bias);  A = -exp(A_log)
                y_t = sum_{s <= t} (C_t . B_s) exp(A sum_{s < r <= t} dt_r)
                      dt_s u_s + D u_t                    (per head)
                x += norm(y * silu(z), out_norm) W_out
    logits = norm(x, final_norm) @ embed^T   (tied)

norm is the zero-centred RMSNorm of ``dense.rms_norm``; one group of B
and C is shared by all heads. The decay exponents are summed in float64,
so a decay over two thousand steps is exact to float32.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from servebench.reference.arith import Arith
from servebench.reference.dense import NORM_STD, rms_norm

#: heads whose [S, S] decay matrices are built at once
HEAD_BLOCK = 16
#: mamba2's published initialisation: A in U[1, 16], dt log-uniform in
#: [0.001, 0.1] (dt_bias its softplus inverse), D = 1
A_RANGE = (1.0, 16.0)
DT_RANGE = (0.001, 0.1)


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, tuple]]:
    D, V = cfg["d_model"], cfg["vocab_size"]
    W = cfg["ssm_expand"] * D
    N, P, K = cfg["ssm_state"], cfg["ssm_headdim"], cfg["ssm_conv"]
    H = W // P
    norm = ("normal", (0.0, NORM_STD))

    def dense(fan_in):
        return ("normal", (0.0, 1.0 / math.sqrt(fan_in)))
    specs = [("embed", (V, D)) + dense(D)]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        specs += [(p + "ln", (D,)) + norm,
                  (p + "w_z", (D, W)) + dense(D),
                  (p + "w_x", (D, W)) + dense(D),
                  (p + "w_B", (D, N)) + dense(D),
                  (p + "w_C", (D, N)) + dense(D),
                  (p + "w_dt", (D, H)) + dense(D),
                  (p + "conv_x", (K, W)) + dense(K),
                  (p + "conv_B", (K, N)) + dense(K),
                  (p + "conv_C", (K, N)) + dense(K),
                  (p + "A_log", (H,), "log_uniform", A_RANGE),
                  (p + "dt_bias", (H,), "softplus_inv_log_uniform", DT_RANGE),
                  (p + "D_skip", (H,), "normal", (1.0, NORM_STD)),
                  (p + "out_norm", (W,)) + norm,
                  (p + "w_out", (W, D)) + dense(W)]
    specs.append(("final_norm", (D,)) + norm)
    if not cfg["tie_embeddings"]:
        specs.append(("lm_head", (D, V)) + dense(D))
    return specs


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, F], w [K, F]: y_t = sum_k w[k] x_{t - K + 1 + k}, zero
    before the sequence."""
    K, Fd = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))              # [B, F, S + K - 1]
    return F.conv1d(xp, w.T[:, None, :], groups=Fd).transpose(1, 2)


def ssd(u, dt, A, Bm, Cm, arith: Arith) -> torch.Tensor:
    """u [B, S, H, P]; dt [B, S, H]; A [H]; Bm, Cm [B, S, N] -> y
    [B, S, H, P] (without the D skip)."""
    Bb, S, H, P = u.shape
    y = torch.empty_like(u)
    t = torch.arange(S, device=u.device)
    later = t[None, :] > t[:, None]                        # s > t
    for b in range(Bb):
        cb = arith.mm(Cm[b], Bm[b].T)                       # [t, s]: C_t.B_s
        cum = torch.cumsum(dt[b].double() * A.double(), 0)  # [S, H]
        for h0 in range(0, H, HEAD_BLOCK):
            c = cum[:, h0:h0 + HEAD_BLOCK].T                # [hb, S]
            decay = (c[:, :, None] - c[:, None, :]).masked_fill_(
                later, float("-inf")).exp_().float()        # [hb, t, s]
            m = decay * cb * dt[b, :, h0:h0 + HEAD_BLOCK].T[:, None, :]
            y[b, :, h0:h0 + HEAD_BLOCK] = arith.mm(
                m, u[b, :, h0:h0 + HEAD_BLOCK].transpose(0, 1)
            ).transpose(0, 1)
    return y


def logits(w: Callable[[str], torch.Tensor], tokens: torch.Tensor,
           cfg: dict, arith: Arith) -> torch.Tensor:
    Bb, S = tokens.shape
    D, eps = cfg["d_model"], cfg["norm_eps"]
    W = cfg["ssm_expand"] * D
    P = cfg["ssm_headdim"]
    H = W // P
    x = w("embed")[tokens.long()]
    for i in range(cfg["num_layers"]):
        def p(name):
            return w(f"layers.{i}.{name}")
        h = rms_norm(x, p("ln"), eps)
        z = arith.mm(h, p("w_z"))
        u = F.silu(causal_conv(arith.mm(h, p("w_x")), p("conv_x")))
        Bm = F.silu(causal_conv(arith.mm(h, p("w_B")), p("conv_B")))
        Cm = F.silu(causal_conv(arith.mm(h, p("w_C")), p("conv_C")))
        dt = F.softplus(arith.mm(h, p("w_dt")) + p("dt_bias"))
        A = -torch.exp(p("A_log"))
        uh = u.reshape(Bb, S, H, P)
        y = ssd(uh, dt, A, Bm, Cm, arith) + uh * p("D_skip")[:, None]
        y = rms_norm(y.reshape(Bb, S, W) * F.silu(z), p("out_norm"), eps)
        x = x + arith.mm(y, p("w_out"))
    x = rms_norm(x, w("final_norm"), eps)
    head = w("embed").T if cfg["tie_embeddings"] else w("lm_head")
    return arith.mm(x, head)
