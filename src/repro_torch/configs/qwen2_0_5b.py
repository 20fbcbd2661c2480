"""qwen2-0.5b [dense]: 24L d896 14H (GQA kv=2) ff4864 V151936, QKV bias.
[arXiv:2407.10671; hf]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_0_5b", family="dense",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151936, qkv_bias=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_0_5b_smoke", family="dense",
        num_layers=2, d_model=56, num_heads=2, num_kv_heads=1,
        d_ff=128, vocab_size=256, qkv_bias=True)
