"""Model configurations of the port: its own copies of
``repro.configs``' types and of the configurations ported so far
(``llama3.2-1b``).  The other nine wait for their model families."""
from .base import InputShape, ModelConfig

__all__ = ["InputShape", "ModelConfig"]
