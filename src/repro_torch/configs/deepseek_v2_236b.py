"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d_model=5120 128H d_ff=1536 (per expert) vocab=102400.
"""
from repro_torch.config import MOE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family=MOE,
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
))
