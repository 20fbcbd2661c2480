"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) ff4864 V32000,
MoE 128e top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="arctic_480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        num_experts=128, experts_per_token=2, d_ff_moe=4864,
        moe_dense_residual=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic_480b_smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        num_experts=8, experts_per_token=2, d_ff_moe=96,
        moe_dense_residual=True)
