"""CGP condensation tricks (Sec. V-B, [23, Lemma 1] + Taylor surrogates).

All surrogates here satisfy Marks-Wright GIA Properties (i)-(iii):
 (i)  surrogate upper-bounds the original constraint function,
 (ii) equality at the expansion point,
 (iii) gradient match at the expansion point.
"""
from __future__ import annotations

import numpy as np

from .posy import Posy, const

__all__ = ["amgm_monomial", "ratio_to_posy", "taylor_xlog1x", "taylor_logx"]


def amgm_monomial(p: Posy, z_prev: np.ndarray) -> Posy:
    """AM-GM condensation: posynomial p(x) >= prod_k (u_k(x)/beta_k)^beta_k,
    with beta_k = u_k(x_prev)/p(x_prev); the RHS is a monomial touching p at
    x_prev (value + gradient).  Used to under-approximate *denominators*.

    The weights are a max-shifted softmax over the term logs, so extreme
    expansion points can neither overflow a term value nor divide by a
    zero sum; terms whose weight underflows to exactly 0.0 are masked out
    of the log-coefficient (``0 * log 0`` must contribute 0, not -inf) and
    contribute exactly 0.0 to the exponent row.  The jnp mirror of this
    arithmetic lives in :mod:`repro.opt.refresh` — keep the two in lockstep
    (the fused-refresh parity suite asserts agreement to 1 ulp).
    """
    t = np.log(p.c) + p.A @ z_prev
    mx = t.max()
    e = np.exp(t - mx)
    beta = e / e.sum()
    # monomial coeff = prod (c_k/beta_k)^beta_k, exponents = sum beta_k A_k
    keep = beta > 0.0
    logc = float(np.sum(np.where(
        keep, beta * (np.log(p.c) - np.log(np.where(keep, beta, 1.0))), 0.0)))
    A = (beta[:, None] * p.A).sum(axis=0, keepdims=True)
    return Posy(np.array([np.exp(logc)]), A)


def ratio_to_posy(num: Posy, den: Posy, z_prev: np.ndarray) -> Posy:
    """Inner-approximate the ratio num/den (den posynomial) by the posynomial
    num / amgm_monomial(den): since M(x) <= den(x), num/M >= num/den —
    Property (i) — with equality and matched gradient at z_prev.
    """
    if den.is_monomial:
        return num / den
    return num / amgm_monomial(den, z_prev)


def taylor_xlog1x(x_prev: float):
    """Affine upper bound of phi(x) = x*log(1/x) (concave) at x_prev:
        phi(x) <= (log(1/x_prev) - 1) * x + x_prev.
    Returns (a, b) with phi(x) <= a*x + b; ``a`` may be negative (x_prev > 1/e)
    — callers must move that term across the inequality.
    """
    a = float(np.log(1.0 / x_prev) - 1.0)
    b = float(x_prev)
    return a, b


def taylor_logx(x_prev: float):
    """Affine upper bound of log(x) (concave) at x_prev:
        log(x) <= log(x_prev) - 1 + x / x_prev.
    Returns (a, b) with log(x) <= a*x + b.
    """
    return 1.0 / x_prev, float(np.log(x_prev) - 1.0)
