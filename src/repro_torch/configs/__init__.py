"""Configs of the families this package runs. Importing this package
populates the registry in repro_torch.config; the other architectures of
the JAX package come with their families."""
from repro_torch.configs import qwen3_4b, stablelm_1_6b  # noqa: F401

ARCH_IDS = [
    "stablelm-1.6b",
    "qwen3-4b",
]
