"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, local window 2048,
block pattern (rec, rec, attn) -> runs long_500k.
"""
from repro_torch.config import HYBRID, ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family=HYBRID,
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    local_window=2048,
    ssm_conv=4,
    tie_embeddings=True,
))
