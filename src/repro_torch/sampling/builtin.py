"""Built-in participation models: full, uniform cohorts, importance.

``FullParticipation`` is the neutral base class re-exported under its
registry name.  ``UniformSampling`` draws a fixed-size cohort uniformly
without replacement — with ``S=None`` the cohort size is a GP decision
variable, with an integer ``S`` it is pinned (``S=N`` reduces bitwise to
full participation).  ``ImportanceSampling`` carries per-worker base
probabilities ``p_n`` (systematic PPS draw at runtime; inclusion
probability ``pi_n = S * p_n``).

Bound honesty (see the module docstring of :mod:`repro_torch.sampling.base`):
both pinned and free-``S`` models keep the *exact* inflation factors
``(q_n + 1 - pi_n)/pi_n`` and ``(1/N) sum 1/pi_n`` — free-``S`` problems
carry them in ratio form (positive part in the numerator, the ``-1`` part
AM-GM-condensed into the denominator), the standard GIA condensation with
zero slack at convergence.  The time constraints stay worst-case over all
N workers in both cases.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .base import SamplingModel, check_probs, widen_varmap

__all__ = ["FullParticipation", "UniformSampling", "ImportanceSampling",
           "uniform", "importance"]


@dataclasses.dataclass(frozen=True)
class FullParticipation(SamplingModel):
    """Every worker in every round — the historical pipeline, verbatim."""

    key: str = "full"


@dataclasses.dataclass(frozen=True)
class UniformSampling(SamplingModel):
    """Fixed-size cohort drawn uniformly without replacement.

    ``S=None`` exposes the cohort size as a GP variable (box ``[1, N]``);
    an integer ``S`` pins it.  ``pi_n = S/N`` for every worker, so the
    sample-variance coefficient scales by exactly ``N/S`` regardless of
    the family's aggregation weights.
    """

    key: str = "uniform"
    S: Optional[int] = None       # cohort size; None = optimized by the GP

    def validate(self, N: int) -> None:
        if self.S is not None and not 1 <= int(self.S) <= N:
            raise ValueError(f"cohort size S={self.S} outside [1, N={N}]")

    def is_neutral(self, N: int) -> bool:
        return self.S is not None and int(self.S) == int(N)

    def signature(self, N: int) -> tuple:
        if self.is_neutral(N):
            return ("full",)
        return ("uniform", None if self.S is None else int(self.S))

    @property
    def free_S(self) -> bool:
        return self.S is None

    def pinned_S(self, N: int) -> Optional[int]:
        return None if (self.S is None or self.is_neutral(N)) else int(self.S)

    def extend_varmap(self, vmap, N: int):
        if not self.free_S:
            return vmap
        return widen_varmap(vmap, "S", 1.0, self.s_cap(N))

    def pi(self, N: int) -> Optional[np.ndarray]:
        if self.free_S or self.is_neutral(N):
            return None
        return np.full(N, float(self.S) / N)

    def base_p(self, N: int) -> Optional[np.ndarray]:
        return np.full(N, 1.0 / N) if self.free_S else None

    def q_coeffs(self, q_pairs, N: int) -> Optional[np.ndarray]:
        if self.is_neutral(N):
            return None
        if self.free_S:                    # numerator part (q+1)/p_n; caller / S
            return (np.asarray(q_pairs, np.float64) + 1.0) * float(N)
        pi = float(self.S) / N             # exact (q + 1 - pi)/pi
        return (np.asarray(q_pairs, np.float64) + 1.0 - pi) / pi

    def c3_scale(self, N: int) -> float:
        if self.is_neutral(N):
            return 1.0
        if self.free_S:                    # (1/N) sum 1/p_n = N; caller / S
            return float(N)
        return float(N) / float(self.S)    # exact N/S


@dataclasses.dataclass(frozen=True)
class ImportanceSampling(SamplingModel):
    """Weighted cohort sampling with per-worker base probabilities ``p_n``.

    The runtime draw is systematic PPS sampling — exactly ``S`` distinct
    workers with inclusion probability exactly ``pi_n = S * p_n`` as long
    as every ``pi_n <= 1``, which the cohort cap ``s_cap = min(N,
    1/max p_n)`` guarantees.  The sample-variance scale ``(1/N) sum 1/pi_n``
    is exact for uniform aggregation weights; under family-weighted
    aggregation it is the factorized surrogate of the coupled bound.
    """

    key: str = "importance"
    p: Tuple[float, ...] = ()
    S: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "p", check_probs(self.p))

    def validate(self, N: int) -> None:
        check_probs(self.p, n_workers=N)
        if self.S is not None:
            if not 1 <= int(self.S) <= N:
                raise ValueError(f"cohort size S={self.S} outside "
                                 f"[1, N={N}]")
            if int(self.S) * max(self.p) > 1.0 + 1e-12:
                raise ValueError(
                    f"S={self.S} pushes max inclusion probability "
                    f"{int(self.S) * max(self.p):.4f} above 1; cohort cap "
                    f"is {self.s_cap(N):.2f}")

    def is_neutral(self, N: int) -> bool:
        # pi_n == 1 for every worker — full participation in disguise
        return self.S is not None and \
            all(int(self.S) * pn == 1.0 for pn in self.p)

    def signature(self, N: int) -> tuple:
        if self.is_neutral(N):
            return ("full",)
        return ("importance", None if self.S is None else int(self.S),
                tuple(round(pn, 12) for pn in self.p))

    @property
    def free_S(self) -> bool:
        return self.S is None

    def s_cap(self, N: int) -> float:
        return float(min(float(N), 1.0 / max(self.p)))

    def pinned_S(self, N: int) -> Optional[int]:
        return None if (self.S is None or self.is_neutral(N)) else int(self.S)

    def extend_varmap(self, vmap, N: int):
        if not self.free_S:
            return vmap
        return widen_varmap(vmap, "S", 1.0, self.s_cap(N))

    def pi(self, N: int) -> Optional[np.ndarray]:
        if self.free_S or self.is_neutral(N):
            return None
        return float(self.S) * np.asarray(self.p, np.float64)

    def base_p(self, N: int) -> Optional[np.ndarray]:
        return np.asarray(self.p, np.float64) if self.free_S else None

    def q_coeffs(self, q_pairs, N: int) -> Optional[np.ndarray]:
        if self.is_neutral(N):
            return None
        qp = np.asarray(q_pairs, np.float64)
        pa = np.asarray(self.p, np.float64)
        if self.free_S:                    # numerator part (q+1)/p_n; caller / S
            return (qp + 1.0) / pa
        pi = float(self.S) * pa            # exact (q + 1 - pi)/pi
        return (qp + 1.0 - pi) / pi

    def c3_scale(self, N: int) -> float:
        if self.is_neutral(N):
            return 1.0
        inv = float(np.sum(1.0 / np.asarray(self.p, np.float64)))
        if self.free_S:                    # S-independent part; caller / S
            return inv / N
        return inv / (float(self.S) * N)

    def plan_p(self, N: int) -> Optional[Tuple[float, ...]]:
        del N
        return tuple(float(x) for x in self.p)


def uniform(S: Optional[int] = None) -> UniformSampling:
    """Uniform cohort sampling; ``S=None`` lets the optimizer choose."""
    return UniformSampling(S=None if S is None else int(S))


def importance(p, S: Optional[int] = None) -> ImportanceSampling:
    """Importance sampling with base probabilities ``p`` (sum 1)."""
    return ImportanceSampling(p=tuple(p), S=None if S is None else int(S))
