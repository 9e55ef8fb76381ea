"""Operations and bytes of a sparse mixture-of-experts forward and of a
grouped expert product launch, counted from shapes (the benchmark's own
arithmetic, not the program's), beside ``flops.py``'s dense counts.

A layer routes T = B * S tokens to k experts each: T * k entries, none
dropped (the configurations' capacity holds every entry). Its routed work
is the attention of a dense layer (``flops.dense_layer_flops`` without its
MLP), the router's [T, D] x [D, E] product and the experts' products over
the entries alone: 2 T k D 2F for gate and up, 2 T k F D for down. The
grouped product's bytes: every expert's weights read once (at the cells'
32,768 entries over 128 experts every expert is hit), and the rows in and
out: gate and up read the T token rows once (an entry's row is gathered
from them) and write each entry's hidden row; down reads the hidden row
and writes the entry's output row.
"""
from __future__ import annotations

from servebench.flops import (PEAK_BF16_FLOPS, PEAK_HBM_BYTES,
                              dense_layer_flops)


def expert_width(cfg: dict) -> int:
    return cfg["moe_d_ff"] or cfg["d_ff"]


def entries(cfg: dict, B: int, S: int) -> int:
    """Entries a layer routes: every token to its top_k experts."""
    return B * S * cfg["top_k"]


def gate_up_flops(cfg: dict, n: int) -> int:
    return 2 * n * cfg["d_model"] * 2 * expert_width(cfg)


def down_flops(cfg: dict, n: int) -> int:
    return 2 * n * expert_width(cfg) * cfg["d_model"]


def gate_up_bytes(cfg: dict, T: int, n: int, itemsize: int = 2) -> int:
    D, Fe, E = cfg["d_model"], expert_width(cfg), cfg["num_experts"]
    return itemsize * (2 * E * D * Fe + T * D + n * Fe)


def down_bytes(cfg: dict, n: int, itemsize: int = 2) -> int:
    D, Fe, E = cfg["d_model"], expert_width(cfg), cfg["num_experts"]
    return itemsize * (E * Fe * D + n * Fe + n * D)


def bound_s(flops: int, nbytes: int) -> float:
    """The least time a launch could take: the larger of its operations at
    the bf16 peak and its bytes at HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def gate_up_bound_s(cfg: dict, B: int, S: int) -> float:
    n = entries(cfg, B, S)
    return bound_s(gate_up_flops(cfg, n), gate_up_bytes(cfg, B * S, n))


def down_bound_s(cfg: dict, B: int, S: int) -> float:
    n = entries(cfg, B, S)
    return bound_s(down_flops(cfg, n), down_bytes(cfg, n))


def moe_layer_flops(cfg: dict, B: int, S: int) -> int:
    T, D, E = B * S, cfg["d_model"], cfg["num_experts"]
    attention = dense_layer_flops(dict(cfg, d_ff=0), B, S)
    n = entries(cfg, B, S)
    return (attention + 2 * T * D * E + gate_up_flops(cfg, n)
            + down_flops(cfg, n))


def forward_flops(cfg: dict, B: int, S: int) -> int:
    """One forward over a [B, S] prompt: every layer and the head."""
    head = 2 * B * S * cfg["d_model"] * cfg["vocab_size"]
    return cfg["num_layers"] * moe_layer_flops(cfg, B, S) + head
