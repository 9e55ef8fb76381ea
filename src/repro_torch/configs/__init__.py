"""Configs of the families this package runs. Importing this package
populates the registry in repro_torch.config; the MoE architectures of
the JAX package come with their slice."""
from repro_torch.configs import (  # noqa: F401
    granite_20b, h2o_danube_3_4b, llava_next_mistral_7b, mamba2_2_7b,
    qwen3_4b, recurrentgemma_9b, seamless_m4t_medium, stablelm_1_6b)

ARCH_IDS = [
    "stablelm-1.6b",
    "granite-20b",
    "mamba2-2.7b",
    "qwen3-4b",
    "llava-next-mistral-7b",
    "recurrentgemma-9b",
    "seamless-m4t-medium",
    "h2o-danube-3-4b",
]
