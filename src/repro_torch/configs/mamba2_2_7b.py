"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560 (attn-free) vocab=50280, ssm_state=128, expand=2,
headdim=64 (80 SSD heads).
"""
from repro_torch.config import SSM, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family=SSM,
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
))
