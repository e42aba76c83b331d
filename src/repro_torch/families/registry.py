"""The family registry: name -> :class:`AlgorithmFamily` instance.

This is the authoritative registry behind ``Scenario(family=...)`` and the
legacy ``repro.api.registries.FAMILIES`` mapping (now a thin back-compat
shim over this one).  Unknown names fail with a nearest-match suggestion.
"""
from __future__ import annotations

import difflib
from typing import Dict, Tuple, Union

from .base import AlgorithmFamily

__all__ = ["register", "get_family", "family_names", "resolve"]

_REGISTRY: Dict[str, AlgorithmFamily] = {}


def register(family: AlgorithmFamily, overwrite: bool = False) -> None:
    """Register a family under ``family.key``."""
    if not isinstance(family, AlgorithmFamily):
        raise TypeError(f"expected an AlgorithmFamily, got {type(family)}; "
                        f"legacy varmap factories go through "
                        f"repro.api.registries.register_family")
    if family.key in _REGISTRY and not overwrite:
        raise ValueError(f"family {family.key!r} is already registered; "
                         f"pass overwrite=True to replace it")
    _REGISTRY[str(family.key)] = family


def family_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_family(name: str) -> AlgorithmFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        close = difflib.get_close_matches(str(name), _REGISTRY, n=1)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown family {name!r}{hint}; registered in repro.families: "
            f"{sorted(_REGISTRY)} (add one with repro.families.register, or "
            f"a legacy varmap factory with "
            f"repro.api.registries.register_family)") from None


def resolve(family: Union[str, AlgorithmFamily]) -> AlgorithmFamily:
    """Accept a registry key or an (unregistered) family instance."""
    if isinstance(family, AlgorithmFamily):
        return family
    return get_family(family)
