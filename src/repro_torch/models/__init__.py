"""Model zoo on torch tensors (port of ``repro.models``): dense GQA / MoE /
SSD / hybrid / enc-dec / VLM backbones, forward passes for serving."""
from .model import Model, build_model  # noqa: F401
