"""Operations and bytes of a forward pass and of a flash attention launch,
counted from shapes (the benchmark's own arithmetic, not the program's).

A matrix product [m, k] x [k, n] is 2mkn operations. Attention counts the
(query, key) pairs its mask keeps: causal, and with a window w a query at
t sees max(0, t - w + 1)..t. The SSD scan of Mamba-2 counts its chunked
form's products over the causal half of each chunk (C.B and the decayed
mix) and the chunk-state products; element-wise work and norms are not
counted. Bytes of a flash launch: Q, K and V read once and O written once.
"""
from __future__ import annotations

#: NVIDIA H100 SXM peaks (data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def causal_pairs(S: int, window=None) -> int:
    """(query, key) pairs a causal mask (with an optional window) keeps
    over a sequence of S."""
    w = S if window is None or window >= S else window
    return w * (w + 1) // 2 + (S - w) * w


def head_dim(cfg: dict) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]


def dense_layer_flops(cfg: dict, B: int, S: int) -> int:
    D, H, Kh, Fd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["d_ff"])
    Dh = head_dim(cfg)
    T = B * S
    proj = 2 * T * D * (H * Dh + 2 * Kh * Dh) + 2 * T * H * Dh * D
    mlp = 2 * T * D * Fd * 3
    return proj + mlp + flash_flops(B, H, S, Dh, cfg["sliding_window"])


def ssm_layer_flops(cfg: dict, B: int, S: int) -> int:
    D, N, P, K = (cfg["d_model"], cfg["ssm_state"], cfg["ssm_headdim"],
                  cfg["ssm_conv"])
    W = cfg["ssm_expand"] * D
    H = W // P
    Lc = min(cfg["ssm_chunk"], S)
    T = B * S
    proj = 2 * T * D * (2 * W + 2 * N + H) + 2 * T * W * D
    conv = 2 * T * K * (W + 2 * N)
    nc = S // Lc
    pairs = nc * Lc * (Lc + 1) // 2
    scan = (2 * B * pairs * N            # C.B within each chunk
            + 2 * B * H * pairs * P      # the decayed mix applied to x
            + 2 * 2 * T * H * P * N)     # chunk states and their read-out
    return proj + conv + scan


def forward_flops(cfg: dict, B: int, S: int) -> int:
    """One forward over a [B, S] prompt: every layer and the head."""
    layer = (ssm_layer_flops if cfg["family"] == "ssm"
             else dense_layer_flops)(cfg, B, S)
    head = 2 * B * S * cfg["d_model"] * cfg["vocab_size"]
    return cfg["num_layers"] * layer + head


def flash_flops(B: int, H: int, S: int, Dh: int, window=None) -> int:
    """Q.K^T and P.V over the kept pairs of one causal launch."""
    return 2 * 2 * B * H * causal_pairs(S, window) * Dh


def flash_bytes(B: int, H: int, Kh: int, S: int, Dh: int,
                itemsize: int = 2) -> int:
    return itemsize * B * S * Dh * (2 * H + 2 * Kh)


def flash_bound_s(cfg: dict, B: int, S: int, itemsize: int = 2) -> float:
    """The least time one flash forward launch of this layer could take on
    the card: the larger of its operations at the bf16 peak and its bytes
    at HBM bandwidth."""
    H, Kh, Dh = cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg)
    return max(flash_flops(B, H, S, Dh, cfg["sliding_window"])
               / PEAK_BF16_FLOPS,
               flash_bytes(B, H, Kh, S, Dh, itemsize) / PEAK_HBM_BYTES)
