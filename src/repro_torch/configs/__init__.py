"""Assigned architecture configs. Importing this package populates the
registry in repro_torch.config."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    granite_20b,
    h2o_danube_3_4b,
    llama4_scout_17b_a16e,
    llava_next_mistral_7b,
    mamba2_2_7b,
    qwen3_4b,
    recurrentgemma_9b,
    seamless_m4t_medium,
    stablelm_1_6b,
)

ARCH_IDS = [
    "stablelm-1.6b",
    "granite-20b",
    "llama4-scout-17b-a16e",
    "mamba2-2.7b",
    "qwen3-4b",
    "llava-next-mistral-7b",
    "deepseek-v2-236b",
    "recurrentgemma-9b",
    "seamless-m4t-medium",
    "h2o-danube-3-4b",
]
