"""stablelm-2-1_6b [dense] — [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=5632 vocab=100352,
partial rotary (25%).
"""
from repro_torch.config import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b",
    family=DENSE,
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rotary_pct=0.25,
))
