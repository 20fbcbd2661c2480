"""llama-3.2-vision-90b [vlm]: 100L d8192 64H (GQA kv=8) ff28672 V128256,
cross-attn image layers every 5th layer; patch embeddings stubbed.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama_3_2_vision_90b", family="vlm",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256,
        cross_attn_every=5, num_image_tokens=1601, rope_theta=5e5)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama_3_2_vision_90b_smoke", family="vlm",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        cross_attn_every=5, num_image_tokens=8)
