"""llama4-scout-17b-a16e [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 +
shared expert; iRoPE-style chunked local attention (8192) on 3 of every 4
layers (every 4th layer is full/NoPE) -> runs long_500k.
"""
from repro_torch.config import MOE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family=MOE,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    num_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    attention_chunk=8192,
    chunk_pattern=4,
))
