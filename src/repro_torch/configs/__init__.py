"""Configs of the families this package runs. Importing this package
populates the registry in repro_torch.config; the other architectures of
the JAX package come with their families."""
from repro_torch.configs import (  # noqa: F401
    granite_20b, mamba2_2_7b, qwen3_4b, recurrentgemma_9b, stablelm_1_6b)

ARCH_IDS = [
    "stablelm-1.6b",
    "granite-20b",
    "mamba2-2.7b",
    "qwen3-4b",
    "recurrentgemma-9b",
]
