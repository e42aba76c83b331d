"""Architecture configs of the LM stack (``repro/configs``): the schema and
the configs the port serves so far (qwen3-1.7b, gemma3-4b)."""
from .. import not_ported
from .base import INPUT_SHAPES, ArchConfig, InputShape

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES"]


def __getattr__(name):
    if name == "MeshLayout":
        raise not_ported("MeshLayout (the SPMD mesh fold)", 9)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
