"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding window 4096
-> runs long_500k.
"""
from repro_torch.config import DENSE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    family=DENSE,
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
))
