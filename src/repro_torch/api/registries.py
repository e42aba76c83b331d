"""Registries behind the Scenario facade: step-size rules keyed by the
objective letter, and a back-compat view of the algorithm-family registry.

Algorithm families now live in :mod:`repro_torch.families` — an
:class:`~repro_torch.families.AlgorithmFamily` owns the varmap *and* the
convergence/runtime/codec hooks the pipeline used to hardcode for GenQSGD:

  genqsgd    — K0, K_1..K_N, B all free (Problems 3/5/7/11)
  pm         — PM-SGD: K_n ≡ 1
  fa         — FedAvg: K_n = l * I_n / B (l a shared relaxed-integer var)
  pr         — PR-SGD: B ≡ 1
  gqfedwavg  — GQFedWAvg: weighted aggregation, normalized momentum local
               updates, rotation-preconditioned quantization

This module keeps the historical surface working: ``FAMILIES`` is a mapping
view whose values are varmap factories (reading goes straight to the new
registry; *mutating* it directly is deprecated and warns), and
``register_family`` accepts either a legacy varmap factory — wrapped into a
:class:`~repro_torch.families.GenQSGDFamily` — or a full ``AlgorithmFamily``.
"""
from __future__ import annotations

import warnings
from collections.abc import MutableMapping
from typing import Callable, Dict, Optional

from ..core.step_rules import (ConstantRule, DiminishingRule, ExponentialRule,
                               StepRule)
from ..families import AlgorithmFamily, GenQSGDFamily, get_family
from ..families import family_names as _family_names
from ..families import register as _register
from ..families import registry as _fam_registry
from ..opt.problems import Objective, VarMap

__all__ = [
    "STEP_RULES", "FAMILIES", "register_step_rule", "register_family",
    "make_step_rule", "make_varmap", "family_names",
]

# ---------------------------------------------------------------------------
# step-size rules: objective letter -> rule constructor
# ---------------------------------------------------------------------------
STEP_RULES: Dict[str, Callable[..., StepRule]] = {}


def register_step_rule(name: str, factory: Callable[..., StepRule]) -> None:
    STEP_RULES[str(name)] = factory


register_step_rule("C", ConstantRule)
register_step_rule("E", ExponentialRule)
register_step_rule("D", DiminishingRule)


def make_step_rule(objective, gamma: float,
                   rho: Optional[float] = None) -> StepRule:
    """Construct the step rule matching an objective (J uses the constant
    rule — Lemma 4 shows the jointly-optimal step size is constant)."""
    m = Objective.coerce(objective, _warn=False)
    name = "C" if m is Objective.JOINT else m.value
    factory = STEP_RULES[name]
    if name == "C":
        return factory(gamma)
    return factory(gamma, rho)


# ---------------------------------------------------------------------------
# algorithm families: back-compat view over repro_torch.families
# ---------------------------------------------------------------------------
# legacy factory signature: factory(N, with_extra, samples_per_worker) -> VarMap
FamilyFactory = Callable[[int, bool, float], VarMap]


def register_family(name: str, factory) -> None:
    """Register an algorithm family under ``name``.

    ``factory`` may be a full
    :class:`~repro_torch.families.AlgorithmFamily` (registered as-is under
    its own hooks) or a legacy varmap factory
    ``(N, with_extra, samples_per_worker) -> VarMap`` (wrapped into a
    :class:`~repro_torch.families.GenQSGDFamily`, i.e. GenQSGD semantics for
    aggregation / local updates / codec).
    """
    if isinstance(factory, AlgorithmFamily):
        if factory.key != name:
            import dataclasses
            factory = dataclasses.replace(factory, key=str(name))
        _register(factory, overwrite=True)
        return
    _register(GenQSGDFamily(key=str(name), varmap_factory=factory),
              overwrite=True)


class _FamiliesShim(MutableMapping):
    """``FAMILIES`` of old: a name -> varmap-factory mapping.

    Reads delegate to :mod:`repro_torch.families`; direct mutation still
    works but is deprecated — it can only describe a GenQSGD-semantics
    family, so new code should ``repro_torch.families.register`` an
    ``AlgorithmFamily`` (or call :func:`register_family`).
    """

    def __getitem__(self, name) -> FamilyFactory:
        try:
            fam = get_family(name)
        except ValueError:
            raise KeyError(name) from None
        return fam.make_varmap

    def __setitem__(self, name, factory) -> None:
        warnings.warn(
            "mutating repro_torch.api.FAMILIES directly is deprecated; use "
            "repro_torch.families.register(AlgorithmFamily(...)) or "
            "repro_torch.api.register_family(name, factory)",
            DeprecationWarning, stacklevel=2)
        register_family(name, factory)

    def __delitem__(self, name) -> None:
        warnings.warn(
            "mutating repro_torch.api.FAMILIES directly is deprecated",
            DeprecationWarning, stacklevel=2)
        del _fam_registry._REGISTRY[name]

    def __iter__(self):
        return iter(_family_names())

    def __len__(self) -> int:
        return len(_family_names())


FAMILIES = _FamiliesShim()


def family_names() -> tuple:
    return _family_names()


def make_varmap(family: str, N: int, with_extra: bool,
                samples_per_worker: float) -> VarMap:
    """The family's decision-variable structure; unknown names raise with a
    nearest-match suggestion pointing at the :mod:`repro_torch.families`
    registry.
    """
    return get_family(family).make_varmap(N, with_extra, samples_per_worker)
