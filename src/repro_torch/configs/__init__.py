"""Architecture configs: one module per assigned architecture.

``get_config(name)`` returns the full published config;
``get_config(name, smoke=True)`` returns the reduced same-family config used
by CPU smoke tests. ``ARCHITECTURES`` lists all assigned ids.
"""
from .base import ModelConfig, ShapeConfig, SHAPES, get_config, ARCHITECTURES  # noqa: F401
