"""Posynomial / monomial algebra for geometric programming.

A posynomial  f(x) = sum_k c_k * prod_i x_i^{A_ki}  with c_k > 0 is stored as
``(c, A)``.  In log variables ``z = log x`` its log is the convex function
``logf(z) = LSE(log c + A z)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Posy", "const", "var", "monomial"]

_F64 = np.dtype(np.float64)


@dataclasses.dataclass
class Posy:
    c: np.ndarray  # (K,) positive coefficients
    A: np.ndarray  # (K, n) exponents

    def __post_init__(self):
        # fast path: the algebra operators below hand in well-formed float64
        # arrays by construction (this constructor is the hot spot of every
        # surrogate refresh in the GIA loop)
        c, A = self.c, self.A
        if not (type(c) is np.ndarray and c.dtype == _F64 and c.ndim == 1):
            self.c = c = np.atleast_1d(np.asarray(c, dtype=np.float64))
        if not (type(A) is np.ndarray and A.dtype == _F64 and A.ndim == 2):
            self.A = A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        assert c.ndim == 1 and A.ndim == 2
        assert c.shape[0] == A.shape[0], (c.shape, A.shape)
        if c.min(initial=np.inf) <= 0:
            raise ValueError(f"posynomial coefficients must be > 0, got {c}")

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.A.shape[1]

    @property
    def n_terms(self) -> int:
        return self.c.shape[0]

    @property
    def is_monomial(self) -> bool:
        return self.n_terms == 1

    # ------------------------------------------------------------------
    def __add__(self, other):
        other = _coerce(other, self.n)
        return Posy(np.concatenate([self.c, other.c]),
                    np.concatenate([self.A, other.A], axis=0))

    __radd__ = __add__

    def __mul__(self, other):
        if np.isscalar(other):
            if other <= 0:
                raise ValueError("scalar factor must be > 0")
            return Posy(self.c * float(other), self.A)
        other = _coerce(other, self.n)
        # general product: cross terms (sizes here are tiny)
        c = (self.c[:, None] * other.c[None, :]).reshape(-1)
        A = (self.A[:, None, :] + other.A[None, :, :]).reshape(-1, self.n)
        return Posy(c, A)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if np.isscalar(other):
            return self * (1.0 / float(other))
        other = _coerce(other, self.n)
        if not other.is_monomial:
            raise ValueError("can only divide by a monomial; condense first")
        return self * Posy(1.0 / other.c, -other.A)

    def __rtruediv__(self, other):
        """scalar / monomial."""
        if not self.is_monomial:
            raise ValueError("can only divide by a monomial; condense first")
        if np.isscalar(other):
            return Posy(np.array([float(other)]) / self.c, -self.A)
        return _coerce(other, self.n) / self

    def __pow__(self, p: float):
        if not self.is_monomial:
            if float(p) == int(p) and p >= 1:
                out = self
                for _ in range(int(p) - 1):
                    out = out * self
                return out
            raise ValueError("non-integer powers only for monomials")
        return Posy(self.c ** float(p), self.A * float(p))

    # ------------------------------------------------------------------
    def logvalue(self, z: np.ndarray) -> float:
        t = np.log(self.c) + self.A @ z
        m = t.max()
        return float(m + np.log(np.exp(t - m).sum()))

    def value(self, z: np.ndarray) -> float:
        """Value at log-point z (i.e. at x = exp(z))."""
        return float(np.exp(self.logvalue(z)))

    def terms(self, z: np.ndarray) -> np.ndarray:
        """Per-term values at log-point z."""
        return np.exp(np.log(self.c) + self.A @ z)

    def grad_hess_log(self, z: np.ndarray):
        """(logf, grad, hess) of logf(z) = LSE(log c + A z) — both analytic."""
        t = np.log(self.c) + self.A @ z
        m = t.max()
        e = np.exp(t - m)
        s = e.sum()
        w = e / s
        g = self.A.T @ w
        H = (self.A.T * w) @ self.A - np.outer(g, g)
        return float(m + np.log(s)), g, H


def _coerce(x, n: int) -> Posy:
    if isinstance(x, Posy):
        assert x.n == n, (x.n, n)
        return x
    if np.isscalar(x):
        return const(float(x), n)
    raise TypeError(type(x))


def const(val: float, n: int) -> Posy:
    return Posy(np.array([val]), np.zeros((1, n)))


def var(i: int, n: int, power: float = 1.0, coeff: float = 1.0) -> Posy:
    A = np.zeros((1, n))
    A[0, i] = power
    return Posy(np.array([coeff]), A)


def monomial(coeff: float, powers: dict, n: int) -> Posy:
    A = np.zeros((1, n))
    for i, p in powers.items():
        A[0, i] = p
    return Posy(np.array([coeff]), A)
