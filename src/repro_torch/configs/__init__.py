"""Model configurations of the port: its own copies of
``repro.configs``' types and of the configurations ported so far
(``llama3.2-1b``, ``mamba2-1.3b``, ``zamba2-2.7b``).  The other seven wait
for their model families."""
from .base import InputShape, ModelConfig

__all__ = ["InputShape", "ModelConfig"]
