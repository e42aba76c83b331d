"""Architecture configs of the LM stack (``repro/configs``): the schema, the
mesh fold and the configs the port carries (qwen3-1.7b, gemma3-4b)."""
from .base import INPUT_SHAPES, ArchConfig, InputShape, MeshLayout

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "MeshLayout"]
