"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) ff12800 V49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_8b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=12800, vocab_size=49155)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_8b_smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256)
