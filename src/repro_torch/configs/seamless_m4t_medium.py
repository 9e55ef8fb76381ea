"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

12L (12 enc + 12 dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
Audio frontend (mel + conv codec) is a stub: input_specs() supplies frame
embeddings for the encoder.
"""
from repro_torch.config import ENCDEC, ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family=ENCDEC,
    source="arXiv:2308.11596",
    num_layers=12,
    num_encoder_layers=12,
    num_decoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    encoder_frames=1024,
))
