"""Convergence-error expressions of GenQSGD (Theorem 1 + Lemmas 1-3).

All functions are NumPy-float implementations (they feed the offline GP-based
parameter optimizer, not the device-side training step) and accept vectorized
``K_n``.

Notation:
  K0        : number of global iterations
  Kn        : array (N,) of per-worker local iteration counts
  B         : mini-batch size
  gammas    : step-size sequence (K0,)
  c = (c1, c2, c3, c4) with
      c1 = 2 N (f(x^(1)) - f*),  c2 = 4 G^2 L^2,  c3 = L sigma^2 / N,
      c4 = 2 L G^2                                    (Theorem 1)
  q_pairs   : array (N,) of q_{s0,sn} = q_{s0} + q_{sn} + q_{s0} q_{sn}
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MLProblemConstants", "coefficients", "c_arbitrary", "c_constant",
           "c_exponential", "c_diminishing", "c_m"]


def _weighted_blocks(Kn: np.ndarray, q_pairs: np.ndarray, eps):
    """``(sum_n eps_n K_n, sum_n q_n (eps_n K_n)^2)`` — the two aggregation
    blocks of the bound.  ``eps=None`` (uniform weights) takes the exact
    historical arithmetic, so GenQSGD results stay bitwise unchanged;
    weighted families (``eps_n = N w_n``, :mod:`repro.families`) reweight
    the effective local work and the quantization variance per worker."""
    if eps is None:
        return Kn.sum(), (q_pairs * Kn**2).sum()
    e = np.asarray(eps, dtype=np.float64)
    eK = e * Kn
    return eK.sum(), (q_pairs * eK**2).sum()


@dataclasses.dataclass(frozen=True)
class MLProblemConstants:
    """Pre-training estimates describing the ML problem (Sec. IV-A)."""
    L: float            # gradient Lipschitz constant (Assumption 3)
    sigma: float        # stochastic-gradient std bound (Assumption 4)
    G: float            # second-moment bound (Assumption 5)
    f_gap: float        # f(x^(1)) - lower bound on f*
    N: int              # number of workers

    @property
    def c(self):
        return coefficients(self.L, self.sigma, self.G, self.f_gap, self.N)


def coefficients(L: float, sigma: float, G: float, f_gap: float, N: int):
    c1 = 2.0 * N * f_gap
    c2 = 4.0 * G**2 * L**2
    c3 = L * sigma**2 / N
    c4 = 2.0 * L * G**2
    return c1, c2, c3, c4


def c_arbitrary(K0, Kn, B, gammas, c, q_pairs, eps=None) -> float:
    """C_A(K, B, Gamma) — eq. (9), arbitrary step-size sequence."""
    c1, c2, c3, c4 = c
    Kn = np.asarray(Kn, dtype=np.float64)
    g = np.asarray(gammas, dtype=np.float64)
    assert g.shape[0] == int(round(K0)), (g.shape, K0)
    q_pairs = np.asarray(q_pairs, dtype=np.float64)
    sum_g = g.sum()
    sum_g2 = (g**2).sum()
    sum_g3 = (g**3).sum()
    sum_K, qK2 = _weighted_blocks(Kn, q_pairs, eps)
    kmax = Kn.max()
    t1 = c1 / (sum_K * sum_g)
    t2 = c2 * kmax**2 * sum_g3 / sum_g
    t3 = c3 * sum_g2 / (B * sum_g)
    t4 = c4 * qK2 * sum_g2 / (sum_K * sum_g)
    return float(t1 + t2 + t3 + t4)


def c_constant(K0, Kn, B, gamma_c, c, q_pairs, eps=None):
    """C_C — eq. (11).  Broadcasts over an ndarray ``K0`` (the feasibility
    grid search evaluates whole K0 ladders at once); scalar in, float out."""
    c1, c2, c3, c4 = c
    Kn = np.asarray(Kn, dtype=np.float64)
    q_pairs = np.asarray(q_pairs, dtype=np.float64)
    sum_K, qK2 = _weighted_blocks(Kn, q_pairs, eps)
    out = (
        c1 / (gamma_c * K0 * sum_K)
        + c2 * gamma_c**2 * Kn.max() ** 2
        + c3 * gamma_c / B
        + c4 * gamma_c * qK2 / sum_K
    )
    return out if np.ndim(K0) else float(out)


def c_exponential(K0, Kn, B, gamma_e, rho_e, c, q_pairs, eps=None):
    """C_E — eq. (13).  Broadcasts over an ndarray ``K0``."""
    c1, c2, c3, c4 = c
    Kn = np.asarray(Kn, dtype=np.float64)
    q_pairs = np.asarray(q_pairs, dtype=np.float64)
    a1 = (1.0 - rho_e) / gamma_e
    a2 = gamma_e**2 / (1.0 + rho_e + rho_e**2)
    a3 = gamma_e / (1.0 + rho_e)
    r1 = rho_e**K0
    sum_K, qK2 = _weighted_blocks(Kn, q_pairs, eps)
    out = (
        a1 * c1 / ((1.0 - r1) * sum_K)
        + a2 * c2 * (1.0 - rho_e ** (3 * K0)) / (1.0 - r1) * Kn.max() ** 2
        + a3 * (1.0 - rho_e ** (2 * K0)) / (1.0 - r1)
        * (c3 / B + c4 * qK2 / sum_K)
    )
    return out if np.ndim(K0) else float(out)


def c_diminishing(K0, Kn, B, gamma_d, rho_d, c, q_pairs, eps=None):
    """C_D — eq. (16) (upper bound used for optimization).  Broadcasts over
    an ndarray ``K0``."""
    c1, c2, c3, c4 = c
    Kn = np.asarray(Kn, dtype=np.float64)
    q_pairs = np.asarray(q_pairs, dtype=np.float64)
    b1 = 1.0 / (rho_d * gamma_d)
    b2 = (rho_d**2 * gamma_d**2) / (rho_d + 1.0) ** 3 \
        + (rho_d**2 * gamma_d**2) / (2.0 * (rho_d + 1.0) ** 2)
    b3 = rho_d * gamma_d / (rho_d + 1.0) ** 2 + rho_d * gamma_d / (rho_d + 1.0)
    logt = np.log((K0 + rho_d + 1.0) / (rho_d + 1.0))
    sum_K, qK2 = _weighted_blocks(Kn, q_pairs, eps)
    out = (
        b1 * c1 / (logt * sum_K)
        + b2 * c2 * Kn.max() ** 2 / logt
        + b3 * c3 / (B * logt)
        + b3 * c4 * qK2 / (logt * sum_K)
    )
    return out if np.ndim(K0) else float(out)


def c_m(m: str, K0, Kn, B, rule, c, q_pairs, eps=None) -> float:
    """Dispatch on the paper's m in {A, C, E, D}."""
    if m == "C":
        return c_constant(K0, Kn, B, rule.gamma, c, q_pairs, eps)
    if m == "E":
        return c_exponential(K0, Kn, B, rule.gamma, rule.rho, c, q_pairs, eps)
    if m == "D":
        return c_diminishing(K0, Kn, B, rule.gamma, rule.rho, c, q_pairs, eps)
    if m == "A":
        return c_arbitrary(K0, Kn, B, rule.sequence(int(round(K0))), c,
                           q_pairs, eps)
    raise ValueError(f"unknown convergence measure m={m!r}")
