"""Config system: model architecture configs, input shapes, registry.

Every assigned architecture is expressed as a ``ModelConfig``; reduced
variants (for CPU smoke tests and FIKIT policy benchmarks) are derived via
``ModelConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"
VLM = "vlm"

FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Defaults suit a dense decoder LM."""

    name: str
    family: str = DENSE
    source: str = ""                 # citation: paper / model card

    # Transformer backbone
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    norm_eps: float = 1e-5
    qk_norm: bool = False            # per-head RMSNorm on q/k (qwen3)
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # fraction of head_dim rotated (stablelm: 0.25)
    tie_embeddings: bool = False

    # Attention variants
    sliding_window: Optional[int] = None     # SWA (mistral/danube)
    attention_chunk: Optional[int] = None    # chunked local attention (llama4 iRoPE)
    chunk_pattern: int = 0                   # every Nth layer is full attention (llama4: 4)

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden; 0 -> d_ff
    capacity_factor: float = 1.25

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0              # 0 -> head_dim

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # Hybrid (recurrentgemma / griffin)
    block_pattern: Tuple[str, ...] = ()      # e.g. ("rec", "rec", "attn")
    lru_width: int = 0               # 0 -> d_model
    local_window: int = 0            # local attention window for "attn" blocks

    # Encoder-decoder (seamless-m4t)
    num_encoder_layers: int = 0
    num_decoder_layers: int = 0
    encoder_frames: int = 1024       # stub audio frontend: frames fed to encoder

    # VLM (llava-next): stub vision frontend supplies patch embeddings
    num_patches: int = 0             # anyres patch count prepended to text

    # numerics
    dtype: str = "bfloat16"          # params/activations
    remat: bool = True               # activation checkpointing for train

    # ----------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.resolved_head_dim

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def subquadratic(self) -> bool:
        """True if decode state is O(1) or O(window) -> long_500k runs."""
        if self.family == SSM:
            return True
        if self.family == HYBRID:
            return True
        if self.sliding_window is not None or self.attention_chunk is not None:
            return True
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=4,
            num_kv_heads=min(max(self.num_kv_heads, 1), 4) if self.num_kv_heads > 1 else 1,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            remat=False,
        )
        if self.family == MOE:
            kw.update(
                num_experts=min(self.num_experts, 4),
                num_shared_experts=min(self.num_shared_experts, 1),
                top_k=min(self.top_k, 2),
                moe_d_ff=min(self.resolved_moe_d_ff, 256),
            )
        if self.use_mla:
            kw.update(kv_lora_rank=64, q_lora_rank=0, rope_head_dim=32,
                      head_dim=64, v_head_dim=64)
        if self.family == SSM:
            kw.update(ssm_state=32, ssm_headdim=32, ssm_chunk=32)
        if self.family == HYBRID:
            kw.update(block_pattern=("rec", "attn"), lru_width=256,
                      local_window=min(self.local_window or 128, 128),
                      num_layers=2)
        if self.family == ENCDEC:
            kw.update(num_encoder_layers=2, num_decoder_layers=2,
                      encoder_frames=32)
        if self.family == VLM:
            kw.update(num_patches=16)
        if self.sliding_window is not None:
            kw.update(sliding_window=min(self.sliding_window, 64))
        if self.attention_chunk is not None:
            kw.update(attention_chunk=min(self.attention_chunk, 64))
        if self.chunk_pattern:
            kw.update(chunk_pattern=2)   # 2 layers: (chunked, full)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry (populated by repro_torch.configs)
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def list_configs() -> list:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
