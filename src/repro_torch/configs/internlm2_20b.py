"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) ff16384 V92544.
[arXiv:2403.17297; hf]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2_20b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92544)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2_20b_smoke", family="dense",
        num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
        d_ff=192, vocab_size=256)
