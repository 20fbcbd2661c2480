"""whisper-medium [audio enc-dec]: 24L d1024 16H (MHA) ff4096 V51865.
Conv frontend stubbed: input_specs feeds 1500 precomputed frame embeddings.
Deviations (DESIGN.md §4): decoder uses RoPE instead of Whisper's learned
448-position table (the assigned 32k decoder lengths exceed it); encoder
keeps learned positions. [arXiv:2212.04356; unverified]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper_medium", family="encdec",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865,
        encoder_layers=24, encoder_frames=1500,
        norm_type="layer", activation="gelu")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper_medium_smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        encoder_layers=2, encoder_frames=16,
        norm_type="layer", activation="gelu")
