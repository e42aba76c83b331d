"""Architecture registry (``repro/models/registry.py``): ``arch id`` ->
config and model API, for the architectures the port carries.

The JAX package's other id (whisper-tiny) raises
:class:`NotImplementedError` naming its ROADMAP item; an id neither package
knows raises :class:`KeyError`.
"""
from __future__ import annotations

import importlib
from types import ModuleType

from .. import not_ported
from ..configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "model_api"]

_CONFIG_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma3-4b": "gemma3_4b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "llama3-405b": "llama3_405b",
    "mistral-large-123b": "mistral_large_123b",
}
#: the JAX package's architectures this package does not carry yet
_NOT_PORTED = ("whisper-tiny",)

ARCH_IDS = tuple(_CONFIG_MODULES)


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch in _NOT_PORTED:
        raise not_ported(f"arch {arch!r}", 10)
    if arch not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"..configs.{_CONFIG_MODULES[arch]}",
                                  __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def model_api(cfg: ArchConfig) -> ModuleType:
    if cfg.encdec:
        raise not_ported("the encoder-decoder model (whisper)", 10)
    from . import lm
    return lm
