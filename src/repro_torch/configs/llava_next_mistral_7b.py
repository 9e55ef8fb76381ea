"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
SWA 4096 -> runs long_500k. Vision frontend is a stub: input_specs()
supplies anyres patch embeddings (2880 patches) prepended to text.
"""
from repro_torch.config import VLM, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family=VLM,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    num_patches=2880,
))
