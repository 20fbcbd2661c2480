"""jamba-v0.1-52b [hybrid]: 32L d4096 32H (GQA kv=8) ff14336 V65536,
MoE 16e top-2, Mamba+attn 1:7 interleave. [arXiv:2403.19887; hf]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="jamba_v0_1_52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        num_experts=16, experts_per_token=2, d_ff_moe=14336, moe_every=2,
        attn_every=8, ssm_state=16, ssm_headdim=64, ssm_expand=2)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba_v0_1_52b_smoke", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        num_experts=4, experts_per_token=2, d_ff_moe=96, moe_every=2,
        attn_every=8, ssm_state=16, ssm_headdim=16, ssm_expand=2)
