"""Model configurations of the port: its own copies of
``repro.configs``' types, of the shape grid and of all ten model
configurations."""
from .base import InputShape, ModelConfig
from .shapes import SHAPES, shapes_for, skip_reason

__all__ = ["InputShape", "ModelConfig", "SHAPES", "shapes_for", "skip_reason"]
