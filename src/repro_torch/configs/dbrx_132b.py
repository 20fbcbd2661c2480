"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) ff10752 V100352,
MoE 16e top-4 fine-grained. [hf:databricks/dbrx-base; unverified]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx_132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        num_experts=16, experts_per_token=4, d_ff_moe=10752)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx_132b_smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        num_experts=4, experts_per_token=2, d_ff_moe=96)
