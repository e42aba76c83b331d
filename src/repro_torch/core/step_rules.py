"""Step-size rules (Sec. III-B): constant (10), exponential (12), diminishing (15)."""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

__all__ = ["ConstantRule", "ExponentialRule", "DiminishingRule", "StepRule",
           "make_rule"]


@dataclasses.dataclass(frozen=True)
class ConstantRule:
    """gamma^(k0) = gamma_c  (eq. 10)."""
    gamma: float
    name = "C"

    def __call__(self, k0: np.ndarray | int):
        return np.broadcast_to(np.float64(self.gamma), np.shape(k0)) if np.ndim(k0) else float(self.gamma)

    def sequence(self, k0_count: int) -> np.ndarray:
        return np.full(k0_count, self.gamma, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ExponentialRule:
    """gamma^(k0) = rho^(k0-1) * gamma_e, rho in (0,1)  (eq. 12)."""
    gamma: float
    rho: float
    name = "E"

    def __post_init__(self):
        if not (0.0 < self.rho < 1.0):
            raise ValueError("exponential rule requires rho in (0, 1)")

    def sequence(self, k0_count: int) -> np.ndarray:
        k = np.arange(1, k0_count + 1, dtype=np.float64)
        return self.gamma * self.rho ** (k - 1.0)


@dataclasses.dataclass(frozen=True)
class DiminishingRule:
    """gamma^(k0) = rho_d * gamma_d / (k0 + rho_d)  (eq. 15)."""
    gamma: float
    rho: float
    name = "D"

    def __post_init__(self):
        if self.rho <= 0:
            raise ValueError("diminishing rule requires rho > 0")

    def sequence(self, k0_count: int) -> np.ndarray:
        k = np.arange(1, k0_count + 1, dtype=np.float64)
        return self.rho * self.gamma / (k + self.rho)


StepRule = Union[ConstantRule, ExponentialRule, DiminishingRule]


def make_rule(name: str, gamma: float, rho: float | None = None) -> StepRule:
    name = name.upper()
    if name == "C":
        return ConstantRule(gamma)
    if name == "E":
        assert rho is not None
        return ExponentialRule(gamma, rho)
    if name == "D":
        assert rho is not None
        return DiminishingRule(gamma, rho)
    raise ValueError(f"unknown step rule {name!r}")
