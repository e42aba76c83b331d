"""The fault registry: name -> :class:`FaultModel` instance.

The authoritative registry behind ``Scenario(faults=...)``.  Unknown
names fail with a nearest-match suggestion, mirroring
:mod:`repro.sampling.registry` / :mod:`repro.families.registry`.
"""
from __future__ import annotations

import difflib
from typing import Dict, Tuple, Union

from .base import FaultModel

__all__ = ["register", "get_faults", "fault_names", "resolve"]

_REGISTRY: Dict[str, FaultModel] = {}


def register(model: FaultModel, overwrite: bool = False) -> None:
    """Register a fault model under ``model.key``."""
    if not isinstance(model, FaultModel):
        raise TypeError(f"expected a FaultModel, got {type(model)}")
    if model.key in _REGISTRY and not overwrite:
        raise ValueError(f"fault model {model.key!r} is already "
                         f"registered; pass overwrite=True to replace it")
    _REGISTRY[str(model.key)] = model


def fault_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_faults(name: str) -> FaultModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        close = difflib.get_close_matches(str(name), _REGISTRY, n=1)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown fault model {name!r}{hint}; registered in "
            f"repro.faults: {sorted(_REGISTRY)} (add one with "
            f"repro.faults.register, or pass a FaultModel instance — "
            f"e.g. repro.faults.edge_faults(straggler_prob=0.2, "
            f"straggler_factor=4.0, deadline_slack=1.5))") from None


def resolve(model: Union[str, FaultModel]) -> FaultModel:
    """Accept a registry key or an (unregistered) model instance."""
    if isinstance(model, FaultModel):
        return model
    return get_faults(model)
