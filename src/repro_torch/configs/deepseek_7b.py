"""deepseek-7b [dense]: 30L d4096 32H (GQA kv=32 ⇒ MHA) ff11008 V102400.
[arXiv:2401.02954; hf]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_7b", family="dense",
        num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=11008, vocab_size=102400)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_7b_smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256)
