"""Architecture configs of the LM stack (``repro/configs``): the schema, the
mesh fold and the configs the port carries (qwen3-1.7b, gemma3-4b,
olmoe-1b-7b, phi3.5-moe-42b-a6.6b, zamba2-2.7b, xlstm-1.3b, qwen2-vl-7b,
llama3-405b, mistral-large-123b, whisper-tiny)."""
from .base import INPUT_SHAPES, ArchConfig, InputShape, MeshLayout

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "MeshLayout"]
