"""Model configurations of the port: its own copies of
``repro.configs``' types and of the configurations ported so far
(``llama3.2-1b``, ``mamba2-1.3b``, ``zamba2-2.7b``, ``starcoder2-3b``,
``granite-3-8b``, ``qwen1.5-110b``, ``moonshot-v1-16b-a3b``,
``arctic-480b``).  The vlm and encdec configurations wait for their
families."""
from .base import InputShape, ModelConfig

__all__ = ["InputShape", "ModelConfig"]
