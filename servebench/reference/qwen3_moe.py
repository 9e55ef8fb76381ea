"""Plain float32 reference of the sparse mixture-of-experts decoder LM as
the configuration runs it (Qwen3-30B-A3B: every layer sparse, no shared
expert).

Written from the equations, not from the program: it imports nothing of
the program and reads only the configuration (a dict of the port's
``ModelConfig`` fields) and the weights the benchmark made. Attention and
the norms are the dense reference's (``dense.py``):

    x = embed[tokens]
    per layer:  h = norm(x, ln1);  x += attn(h);  h = norm(x, ln2)
                p = softmax(h R)                       over the E experts
                S = the top_k largest of p;  g_e = p_e / sum_{j in S} p_j
                x += sum_{e in S} g_e (silu(h W1_e) * (h W3_e)) W2_e
    logits = norm(x, final_norm) @ lm_head

Every token goes to its top_k experts: the configuration's capacity
(``capacity_factor`` = E / top_k) holds every entry, so nothing is
dropped. The experts are computed one at a time over the tokens routed to
them, so the reference fits beside the weights. Ties between equal
probabilities go to the lower expert.

Parameter names and shapes are those the port's modules hold
(``layers.<i>.moe.router`` [D, E], ``w1``, ``w3`` [E, D, F], ``w2``
[E, F, D]), so the benchmark can load the same tensors into both.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from servebench.reference.arith import Arith
from servebench.reference.dense import (NORM_STD, attend, head_dim,
                                        rms_norm, rotate)


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, tuple]]:
    """(name, shape, kind, args) of every parameter; kind "normal" draws
    N(args[0], args[1])."""
    D, H, Kh, V = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                   cfg["vocab_size"])
    E, Fe = cfg["num_experts"], cfg["moe_d_ff"] or cfg["d_ff"]
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
                  (p + "moe.router", (D, E)) + dense(D),
                  (p + "moe.w1", (E, D, Fe)) + dense(D),
                  (p + "moe.w3", (E, D, Fe)) + dense(D),
                  (p + "moe.w2", (E, Fe, D)) + dense(Fe)]
    specs.append(("final_norm", (D,)) + norm)
    if not cfg["tie_embeddings"]:
        specs.append(("lm_head", (D, V)) + dense(D))
    return specs


def route(h2: torch.Tensor, router: torch.Tensor, k: int, arith: Arith):
    """h2 [T, D] -> (gates [T, k], experts [T, k]): the k most probable
    experts (the lower one first on a tie), their probabilities
    renormalised to sum to one."""
    probs = torch.softmax(arith.mm(h2, router), dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = top[:, :k]
    return top / top.sum(dim=-1, keepdim=True), experts[:, :k]


def experts_apply(h2, gates, experts, w1, w3, w2, arith: Arith):
    """sum over each token's experts of gate * expert(h), one expert at a
    time over the tokens routed to it."""
    out = torch.zeros_like(h2)
    for e in range(w1.shape[0]):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = h2[tok]
        y = arith.mm(F.silu(arith.mm(rows, w1[e])) * arith.mm(rows, w3[e]),
                     w2[e])
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
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
        h2 = rms_norm(x, p("ln2"), eps).reshape(B * S, D)
        gates, experts = route(h2, p("moe.router"), cfg["top_k"], arith)
        x = x + experts_apply(h2, gates, experts, p("moe.w1"), p("moe.w3"),
                              p("moe.w2"), arith).reshape(B, S, D)
    x = rms_norm(x, w("final_norm"), eps)
    head = w("embed").T if cfg["tie_embeddings"] else w("lm_head")
    return arith.mm(x, head)
