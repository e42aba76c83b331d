"""The sampling registry: name -> :class:`SamplingModel` instance.

The authoritative registry behind ``Scenario(sampling=...)``.  Unknown
names fail with a nearest-match suggestion, mirroring
:mod:`repro.families.registry`.
"""
from __future__ import annotations

import difflib
from typing import Dict, Tuple, Union

from .base import SamplingModel

__all__ = ["register", "get_sampling", "sampling_names", "resolve"]

_REGISTRY: Dict[str, SamplingModel] = {}


def register(model: SamplingModel, overwrite: bool = False) -> None:
    """Register a sampling model under ``model.key``."""
    if not isinstance(model, SamplingModel):
        raise TypeError(f"expected a SamplingModel, got {type(model)}")
    if model.key in _REGISTRY and not overwrite:
        raise ValueError(f"sampling model {model.key!r} is already "
                         f"registered; pass overwrite=True to replace it")
    _REGISTRY[str(model.key)] = model


def sampling_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_sampling(name: str) -> SamplingModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        close = difflib.get_close_matches(str(name), _REGISTRY, n=1)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown sampling model {name!r}{hint}; registered in "
            f"repro.sampling: {sorted(_REGISTRY)} (add one with "
            f"repro.sampling.register, or pass a SamplingModel instance — "
            f"e.g. repro.sampling.uniform(S=...) / "
            f"repro.sampling.importance(p, S=...))") from None


def resolve(model: Union[str, SamplingModel]) -> SamplingModel:
    """Accept a registry key or an (unregistered) model instance."""
    if isinstance(model, SamplingModel):
        return model
    return get_sampling(model)
