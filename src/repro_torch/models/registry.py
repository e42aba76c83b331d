"""Architecture registry (``repro/models/registry.py``): ``arch id`` ->
config and model API, for every architecture of the JAX package.

``model_api(cfg)`` returns the module implementing the uniform interface
(init_params / loss_train / prefill / decode_step / init_caches):
decoder-only LMs use :mod:`repro_torch.models.lm`, enc-dec uses
:mod:`repro_torch.models.whisper`.  An unknown id raises :class:`KeyError`.
"""
from __future__ import annotations

import importlib
from types import ModuleType

from ..configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "model_api"]

_CONFIG_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma3-4b": "gemma3_4b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3-405b": "llama3_405b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-tiny": "whisper_tiny",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
}

ARCH_IDS = tuple(_CONFIG_MODULES)


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"..configs.{_CONFIG_MODULES[arch]}",
                                  __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def model_api(cfg: ArchConfig) -> ModuleType:
    if cfg.encdec:
        from . import whisper
        return whisper
    from . import lm
    return lm
