"""mamba2-370m [ssm]: 48L d1024 attn-free V50280, ssm_state=128 (SSD).
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, head_dim=1)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_370m_smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, head_dim=1)
