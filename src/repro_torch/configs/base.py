"""Config dataclasses + registry for the assigned architectures (the port's
copy of ``repro.configs.base``, which imports no JAX: the same fields,
shapes and registry)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 → d_model // num_heads
    qkv_bias: bool = False
    norm_type: str = "rms"      # rms | layer
    activation: str = "swiglu"  # swiglu | gelu
    pos_embed: str = "rope"     # rope | learned
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_moe: int = 0           # 0 → d_ff
    moe_dense_residual: bool = False
    moe_every: int = 1          # MoE FF on every k-th layer (jamba: 2)
    # --- SSM ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0         # hybrid: one attn layer per k (jamba: 8)
    # --- enc-dec ---
    encoder_layers: int = 0
    encoder_frames: int = 0     # stubbed audio frontend length
    # --- VLM ---
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # --- misc ---
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    max_position: int = 1 << 20

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.num_heads))
        if self.num_experts and not self.d_ff_moe:
            object.__setattr__(self, "d_ff_moe", self.d_ff)

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so embed/lm_head shard
        over any mesh axis (Megatron-style vocab padding). Pad logits are
        masked to -inf in the loss/decode (§Perf iteration 2)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    @property
    def period(self) -> int:
        """Layers per scanned block (the smallest repeating pattern)."""
        if self.family == "hybrid":
            return self.attn_every
        if self.family == "vlm":
            return self.cross_attn_every
        return 1

    @property
    def num_blocks(self) -> int:
        assert self.num_layers % self.period == 0
        return self.num_layers // self.period

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCHITECTURES = (
    "granite_3_8b",
    "deepseek_7b",
    "internlm2_20b",
    "qwen2_0_5b",
    "arctic_480b",
    "dbrx_132b",
    "whisper_medium",
    "mamba2_370m",
    "jamba_v0_1_52b",
    "llama_3_2_vision_90b",
)

# long_500k needs sub-quadratic token mixing; only SSM/hybrid families
# qualify (DESIGN.md §4).
LONG_CONTEXT_ARCHS = ("mamba2_370m", "jamba_v0_1_52b")


def supports_shape(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke_config() if smoke else mod.full_config()


def smoke_shape(kind: str = "train") -> ShapeConfig:
    if kind == "train":
        return ShapeConfig("smoke_train", 64, 2, "train")
    if kind == "prefill":
        return ShapeConfig("smoke_prefill", 64, 2, "prefill")
    return ShapeConfig("smoke_decode", 64, 2, "decode")
