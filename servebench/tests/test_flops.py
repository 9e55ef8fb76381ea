"""The benchmark's operation and byte counts against hand counts."""
import pytest

from servebench import flops

DENSE = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2,
         "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 10,
         "sliding_window": None}
SSM = {"family": "ssm", "num_layers": 1, "d_model": 4, "ssm_state": 2,
       "ssm_headdim": 2, "ssm_expand": 2, "ssm_conv": 3, "ssm_chunk": 2,
       "vocab_size": 5}


@pytest.mark.parametrize("S, window, pairs", [
    (4, None, 1 + 2 + 3 + 4),
    (5, 2, 1 + 2 + 2 + 2 + 2),
    (3, 8, 1 + 2 + 3),
])
def test_causal_pairs(S, window, pairs):
    assert flops.causal_pairs(S, window) == pairs


@pytest.mark.parametrize("B, S", [(1, 4), (3, 5)])
def test_dense_forward_by_hand(B, S):
    T = B * S
    # q [8 -> 8], k and v [8 -> 4] each, o [8 -> 8]; MLP 3 x [8 x 16]
    proj = 2 * T * (8 * 8 + 2 * 8 * 4 + 8 * 8)
    mlp = 2 * T * 3 * 8 * 16
    attn = 2 * 2 * B * 2 * 4 * (S * (S + 1) // 2)
    head = 2 * T * 8 * 10
    assert flops.forward_flops(DENSE, B, S) == 2 * (proj + mlp + attn) + head


@pytest.mark.parametrize("B, S", [(1, 2), (2, 4)])
def test_ssm_forward_by_hand(B, S):
    T, W, N, H, P, K = B * S, 8, 2, 4, 2, 3
    proj = 2 * T * 4 * (2 * W + 2 * N + H) + 2 * T * W * 4
    conv = 2 * T * K * (W + 2 * N)
    pairs = (S // 2) * 3                     # chunks of 2: 3 pairs each
    scan = 2 * B * pairs * N + 2 * B * H * pairs * P + 4 * T * H * P * N
    head = 2 * T * 4 * 5
    assert flops.forward_flops(SSM, B, S) == proj + conv + scan + head


@pytest.mark.parametrize("B, H, Kh, S, D, window", [
    (2, 32, 32, 1024, 64, None),
    (4, 32, 8, 256, 120, 4096),
])
def test_flash_counts_and_bound(B, H, Kh, S, D, window):
    pairs = S * (S + 1) // 2
    assert flops.flash_flops(B, H, S, D, window) == 4 * B * H * pairs * D
    nbytes = 2 * (B * S * H * D * 2 + B * S * Kh * D * 2)
    assert flops.flash_bytes(B, H, Kh, S, D) == nbytes
    cfg = {"num_heads": H, "num_kv_heads": Kh, "head_dim": D,
           "d_model": H * D, "sliding_window": window}
    assert flops.flash_bound_s(cfg, B, S) == max(
        4 * B * H * pairs * D / 989e12, nbytes / 3.35e12)
