"""Problems 3, 5, 7, 11 of the paper as GP-sequence generators.

Each ``*_builder`` returns a function ``build(z_prev) -> GP`` producing the
iteration-t approximate GP (Problems 4, 6, 8, 12) at the previous point — the
GIA outer loop (Algorithms 2-5) lives in :mod:`repro.opt.gia`.

Variable space (log-space vector z), in order:
    K0, K_1..K_N, B, T1, T2 [, X0 | gamma]
Baselines (PM-SGD / FedAvg / PR-SGD parameter optimization, Sec. VII) reuse
the same constructors through a ``VarMap`` that pins or ties variables:
  PM:  K_n ≡ 1;   FA:  K_n = l * I_n / B (new var l);   PR:  B ≡ 1.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.convergence import MLProblemConstants
from ..core.cost import EdgeSystem
from .condense import amgm_monomial, ratio_to_posy, taylor_logx, taylor_xlog1x
from .gp import GP
from .posy import Posy, const, var

__all__ = ["Objective", "ParamOptProblem", "VarMap", "identity_varmap",
           "pm_varmap", "fa_varmap", "pr_varmap"]


class Objective(str, enum.Enum):
    """The paper's convergence-error measure m — which Problem is solved.

    A ``str`` subclass so member values compare equal to the historical
    one-letter codes (``Objective.CONSTANT == "C"``); the rest of the
    optimizer keeps matching on the letters.
    """

    CONSTANT = "C"        # Problem 3: fixed constant step size (eq. 10)
    EXPONENTIAL = "E"     # Problem 5: exponential step-size rule (eq. 12)
    DIMINISHING = "D"     # Problem 7: diminishing step-size rule (eq. 15)
    JOINT = "J"           # Problem 11: jointly optimized (constant) step size

    @classmethod
    def coerce(cls, m: Union["Objective", str],
               _warn: bool = True) -> "Objective":
        """Accept an Objective or a legacy "C"|"E"|"D"|"J" string.

        Bare strings are the deprecated spelling; they keep working but
        warn once per call site.
        """
        if isinstance(m, cls):
            return m
        try:
            out = cls(m)
        except ValueError:
            raise ValueError(
                f"unknown objective {m!r}; expected one of "
                f"{[o.value for o in cls]} or a repro.api.Objective") from None
        if _warn:
            # caller -> generated __init__ -> __post_init__ -> coerce
            warnings.warn(
                f"stringly-typed m={m!r} is deprecated; use "
                f"repro.api.Objective.{out.name}", DeprecationWarning,
                stacklevel=4)
        return out

    @property
    def needs_rho(self) -> bool:
        return self in (Objective.EXPONENTIAL, Objective.DIMINISHING)

    @property
    def needs_gamma(self) -> bool:
        return self is not Objective.JOINT


# ---------------------------------------------------------------------------
# Variable mapping
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class VarMap:
    """Maps paper variables to monomials over the actual optimization vars."""
    n: int                               # number of actual variables
    names: List[str]                     # debug names of actual variables
    K0: Posy
    Kn: List[Posy]                       # N entries (monomials)
    B: Posy
    T1: Posy
    T2: Posy
    extra: Optional[Posy] = None         # X0 (m=E) or gamma (joint)
    lower: Optional[np.ndarray] = None   # per-actual-var lower bounds (>0)
    upper: Optional[np.ndarray] = None

    def z0_default(self) -> np.ndarray:
        return np.zeros(self.n)


def identity_varmap(N: int, with_extra: bool = False) -> VarMap:
    """K0, K_1..K_N, B, T1, T2 (+extra) all free."""
    n = N + 4 + (1 if with_extra else 0)
    names = (["K0"] + [f"K{i+1}" for i in range(N)] + ["B", "T1", "T2"]
             + (["extra"] if with_extra else []))
    lower = np.full(n, 1e-12)
    upper = np.full(n, 1e12)
    lower[0] = 1.0                       # K0 >= 1
    lower[1:N + 1] = 1.0                 # Kn >= 1
    lower[N + 1] = 1.0                   # B >= 1
    return VarMap(
        n=n, names=names,
        K0=var(0, n), Kn=[var(1 + i, n) for i in range(N)],
        B=var(N + 1, n), T1=var(N + 2, n), T2=var(N + 3, n),
        extra=var(N + 4, n) if with_extra else None,
        lower=lower, upper=upper)


def pm_varmap(N: int, with_extra: bool = False) -> VarMap:
    """PM-SGD: K_n ≡ 1.  Vars: K0, B, T1, T2 (+extra)."""
    n = 4 + (1 if with_extra else 0)
    names = ["K0", "B", "T1", "T2"] + (["extra"] if with_extra else [])
    lower = np.full(n, 1e-12); upper = np.full(n, 1e12)
    lower[0] = 1.0; lower[1] = 1.0
    return VarMap(n=n, names=names, K0=var(0, n),
                  Kn=[const(1.0, n) for _ in range(N)],
                  B=var(1, n), T1=var(2, n), T2=var(3, n),
                  extra=var(4, n) if with_extra else None,
                  lower=lower, upper=upper)


def fa_varmap(N: int, I_n: Sequence[float], with_extra: bool = False) -> VarMap:
    """FedAvg: K_n = l * I_n / B, l a positive (relaxed-integer) variable.

    Vars: K0, l, B, T1, T2 (+extra).
    """
    n = 5 + (1 if with_extra else 0)
    names = ["K0", "l", "B", "T1", "T2"] + (["extra"] if with_extra else [])
    lower = np.full(n, 1e-12); upper = np.full(n, 1e12)
    lower[0] = 1.0; lower[1] = 1.0; lower[2] = 1.0
    l, B = var(1, n), var(2, n)
    return VarMap(n=n, names=names, K0=var(0, n),
                  Kn=[l * float(I_n[i]) / B for i in range(N)],
                  B=B, T1=var(3, n), T2=var(4, n),
                  extra=var(5, n) if with_extra else None,
                  lower=lower, upper=upper)


def pr_varmap(N: int, with_extra: bool = False) -> VarMap:
    """PR-SGD: B ≡ 1.  Vars: K0, K_1..K_N, T1, T2 (+extra)."""
    n = N + 3 + (1 if with_extra else 0)
    names = (["K0"] + [f"K{i+1}" for i in range(N)] + ["T1", "T2"]
             + (["extra"] if with_extra else []))
    lower = np.full(n, 1e-12); upper = np.full(n, 1e12)
    lower[0] = 1.0; lower[1:N + 1] = 1.0
    return VarMap(n=n, names=names, K0=var(0, n),
                  Kn=[var(1 + i, n) for i in range(N)],
                  B=const(1.0, n), T1=var(N + 1, n), T2=var(N + 2, n),
                  extra=var(N + 3, n) if with_extra else None,
                  lower=lower, upper=upper)


def _log_posy_batch(p: Posy, Z: np.ndarray) -> np.ndarray:
    """log p(exp(z)) for a (G, n) batch of log-points — the vectorized
    counterpart of :meth:`Posy.logvalue`."""
    t = np.log(p.c)[None, :] + Z @ p.A.T          # (G, K)
    m = t.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(t - m).sum(axis=1, keepdims=True)))[:, 0]


# ---------------------------------------------------------------------------
# Problem family
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ParamOptProblem:
    """One instance of the paper's parameter-optimization problem.

    ``m`` selects the convergence-error measure: "C", "E", "D" (Problems
    3/5/7, fixed step-size sequence) or "J" (Problem 11, joint optimization of
    the — by Lemma 4 constant — step size).
    """
    sys: EdgeSystem
    consts: MLProblemConstants
    T_max: float
    C_max: float
    m: Union[Objective, str]             # Objective (or legacy "C"|"E"|"D"|"J")
    gamma: Optional[float] = None        # step size (m in C/E/D)
    rho: Optional[float] = None          # rho_E or rho_D
    vmap: Optional[VarMap] = None
    family: object = "genqsgd"           # repro.families key or instance
    sampling: object = "full"            # repro.sampling key or instance
    faults: object = "none"              # repro.faults key or instance

    def __post_init__(self):
        from ..families import resolve   # lazy: families imports this module
        from ..sampling import resolve as resolve_sampling   # ditto
        from ..faults import resolve as resolve_faults       # ditto
        self.m = Objective.coerce(self.m)
        self.family = resolve(self.family)
        self.family.agg_eps(self.sys.N)  # N-mismatched weights fail loudly
        self.sampling = resolve_sampling(self.sampling)
        self.sampling.validate(self.sys.N)
        self.faults = resolve_faults(self.faults)
        self.faults.validate(self.sys.N)
        if self.vmap is None:
            self.vmap = identity_varmap(
                self.sys.N,
                with_extra=self.m in (Objective.EXPONENTIAL, Objective.JOINT))
        # free-cohort models append the "S" decision variable *after* every
        # family variable (extra included), so positional lookups stay valid
        if self.sampling.free_S and "S" not in self.vmap.names:
            self.vmap = self.sampling.extend_varmap(self.vmap, self.sys.N)
        if self.m is not Objective.JOINT and self.gamma is None:
            raise ValueError(f"m={self.m} requires a fixed gamma")
        if self.m.needs_rho and self.rho is None:
            raise ValueError(f"m={self.m} requires rho")

    # -- family hooks (repro.families): coefficient-only reweighting ---------
    # The family only moves *coefficients* of the convergence block (weights
    # in the aggregation sums, scales on c2/c3); term counts and exponent
    # structure stay family-independent, so every family batches and fuses
    # through repro.opt.refresh / gia_jax unchanged.
    @functools.cached_property
    def _agg_eps(self) -> Optional[np.ndarray]:
        """Effective aggregation weights eps_n = N w_n (None = uniform)."""
        return self.family.agg_eps(self.sys.N)

    # -- fault hooks (repro.faults): availability as coefficients -----------
    # Per-worker availability a_n composes with sampling exactly as
    # pi_n -> a_n pi_n: the same ratio-form machinery carries the joint
    # coefficient, so faulted problems batch and fuse unchanged.  a_n = None
    # leaves every branch below on the historical code path, bitwise.
    @functools.cached_property
    def _an(self) -> Optional[np.ndarray]:
        """Per-worker availability (None = always available, bitwise).
        ``sys.an`` (stamped by Scenario or set directly) wins; otherwise
        the fault model's stationary availability."""
        if self.sys.an is not None:
            return self.sys.an
        return self.faults.availability(self.sys.N)

    @functools.cached_property
    def _c_eff(self):
        """Theorem-1 coefficients with the family's (c2, c3) scales *and*
        the sampling/fault models' c3 inflation folded in; scales of
        exactly 1.0 leave the floats bitwise untouched."""
        c1, c2, c3, c4 = self.consts.c
        c2s, c3s = self.family.c_scales(self.sys.N)
        if c2s != 1.0:
            c2 = c2 * c2s
        if c3s != 1.0:
            c3 = c3 * c3s
        an = self._an
        if an is None:
            s3 = self.sampling.c3_scale(self.sys.N)
            if s3 != 1.0:
                c3 = c3 * s3
        else:
            # joint exact scale (1/N) sum 1/(a_n pi_n) — the sampling form
            # with pi_n -> a_n pi_n (free-S: its S-independent part
            # (1/N) sum 1/(a_n p_n); the caller multiplies by S^{-1})
            N = self.sys.N
            if self.sampling.free_S:
                pe = an * self.sampling.base_p(N)
            else:
                pi = self.sampling.pi(N)
                pe = an if pi is None else an * pi
            c3 = c3 * float(np.sum(1.0 / pe) / N)
        return c1, c2, c3, c4

    # -- sampling hooks (repro.sampling): participation as coefficients ------
    # Pinned cohorts are pure coefficient changes (exact inflation factors);
    # free-S models additionally append the "S" variable and multiply the
    # variance blocks by the S^{-1} monomial — still posynomial, so sampled
    # problems batch and fuse through refresh/gia_jax unchanged.
    @functools.cached_property
    def _i_S(self) -> Optional[int]:
        """Index of the free cohort-size variable (None = pinned/full)."""
        try:
            return self.vmap.names.index("S")
        except ValueError:
            return None

    def _over_S(self, p: Posy) -> Posy:
        """``p / S`` when the cohort size is a free variable (no-op —
        the same object, bitwise — for pinned/full participation)."""
        if self._i_S is None:
            return p
        return p / var(self._i_S, self.vmap.n)

    def _pi_at(self, S: Optional[float] = None) -> Optional[np.ndarray]:
        """Inclusion probabilities at cohort size ``S`` (None = full)."""
        return self.sampling.pi_at(self.sys.N, S)

    def _conv_coeffs(self, S: Optional[float] = None):
        """``(c, q_pairs)`` for the closed-form convergence bound with the
        *exact* sampling inflation at concrete cohort size ``S``.

        This is the bound ``evaluate`` / integer recovery / the feasibility
        flag report.  For free-``S`` models the GP surrogate instead uses
        the conservative posynomial relaxation ``(q+1)/pi >= (q+1-pi)/pi``
        (exactness at ``pi -> 1`` is impossible for a posynomial in ``S``),
        so the surrogate steers and the closed form validates — the same
        split the m=E Taylor constraints already follow.  The ``c3``
        variance-mean scale has no such slack: ``(1/N) sum 1/pi_n`` equals
        the relaxed-part/``S`` exactly, for every builtin model.

        Under availability ``a_n`` (repro.faults) the effective inclusion
        probability is ``a_n pi_n`` and the same exact forms apply with
        that substitution."""
        c = self._c_eff
        qp = self.sys.q_pairs
        an = self._an
        if self._i_S is not None:
            if S is None:
                raise ValueError("free-S sampling problem: pass the cohort "
                                 "size S to evaluate the bound")
            Sf = float(S)
            c = (c[0], c[1], c[2] / Sf, c[3])
            if an is None:
                qp = self.sampling.q_coeffs_at(qp, self.sys.N, Sf)
            else:
                pe = an * self.sampling.pi_at(self.sys.N, Sf)
                qp = (np.asarray(qp, np.float64) + 1.0 - pe) / pe
        elif an is None:
            sq = self.sampling.q_coeffs(qp, self.sys.N)
            if sq is not None:
                qp = sq
        else:
            pi = self.sampling.pi(self.sys.N)
            pe = an if pi is None else an * pi
            qp = (np.asarray(qp, np.float64) + 1.0 - pe) / pe
        return c, qp

    # -- shared pieces ------------------------------------------------------
    def _objective(self) -> Posy:
        v, s = self.vmap, self.sys
        e = s.comp_energy_coeff
        pi = self.sampling.pi(s.N)
        p = self.sampling.base_p(s.N) if self.sampling.free_S else None
        if pi is None and p is None:       # full participation, verbatim
            obj = float(s.const_energy) * v.K0
            for i in range(s.N):
                obj = obj + float(e[i]) * (v.K0 * v.B * v.Kn[i])
            return obj
        comm = s.comm_energy_coeff         # p_n M_sn / r_n per worker
        if p is not None:                  # free S: pi_n = p_n * S
            Sm = var(self._i_S, v.n)
            obj = float(s.server_energy) * v.K0 \
                + float(np.sum(comm * p)) * (v.K0 * Sm)
            for i in range(s.N):
                obj = obj + float(e[i] * p[i]) * (v.K0 * v.B * v.Kn[i] * Sm)
            return obj
        # pinned cohort: constant pi_n folded into the coefficients
        obj = float(s.server_energy + np.sum(comm * pi)) * v.K0
        for i in range(s.N):
            obj = obj + float(e[i] * pi[i]) * (v.K0 * v.B * v.Kn[i])
        return obj

    def _common_constraints(self) -> List[Posy]:
        v, s = self.vmap, self.sys
        cons: List[Posy] = []
        # worst-case-over-the-box capabilities (repro.faults margins);
        # identical objects — bitwise — at zero margins
        ct = s.comp_time_coeff_wc
        for i in range(s.N):                       # (22)
            cons.append(float(ct[i]) * v.Kn[i] / v.T1)
        for i in range(s.N):                       # (23)
            cons.append(v.Kn[i] / v.T2)
        tau = s.comm_time_wc                       # (24)
        cons.append((tau / self.T_max) * v.K0
                    + (1.0 / self.T_max) * (v.K0 * v.B * v.T1))
        # box bounds on the actual variables
        n = v.n
        for i in range(n):
            if v.lower is not None and v.lower[i] > 0:
                cons.append(Posy(np.array([v.lower[i]]), -np.eye(n)[i:i+1]))
            if v.upper is not None and np.isfinite(v.upper[i]):
                cons.append(Posy(np.array([1.0 / v.upper[i]]), np.eye(n)[i:i+1]))
        return cons

    def _sum_Kn(self) -> Posy:
        """sum_n eps_n K_n (eps=None: the unweighted historical sum)."""
        eps = self._agg_eps
        terms = self.vmap.Kn if eps is None else \
            [float(eps[i]) * self.vmap.Kn[i] for i in range(self.sys.N)]
        out = terms[0]
        for k in terms[1:]:
            out = out + k
        return out

    def _sum_q_Kn2(self) -> Posy:
        """sum_n q_n (eps_n K_n)^2 — the quantization-variance block, with
        the sampling model's participation inflation on q_n.

        For a free cohort size this is the *positive* part of the exact
        inflated block: ``q_eff_n = (q_n+1)/(p_n S) - 1`` splits into
        ``(q_n+1)/p_n * S^{-1}`` (returned here, divided by the S monomial)
        minus 1; the negative part (:meth:`_sum_Kn2_eps`) moves to the
        ratio denominator in :meth:`_conv_constraint`, so the GP encodes
        the exact bound — no relaxation slack.  Availability composes as
        ``pi_n -> a_n pi_n`` throughout (the numerator picks up a
        ``1/a_n``; the ``-1`` part is availability-independent)."""
        qp = self.sys.q_pairs
        an = self._an
        if an is None:
            sq = self.sampling.q_coeffs(qp, self.sys.N)
            if sq is not None:
                qp = sq
        elif self._i_S is not None:
            # free S: exact numerator (q+1)/(a_n p_n); the caller's S^{-1}
            # and the -1 denominator part complete the exact joint form
            qp = self.sampling.q_coeffs(qp, self.sys.N) / an
        else:
            pi = self.sampling.pi(self.sys.N)
            pe = an if pi is None else an * pi
            qp = (np.asarray(qp, np.float64) + 1.0 - pe) / pe
        eps = self._agg_eps
        v = self.vmap
        out = None
        for i in range(self.sys.N):
            q = max(qp[i], 1e-300)
            if eps is not None:
                q = q * float(eps[i]) ** 2
            t = float(q) * (v.Kn[i] ** 2)
            out = t if out is None else out + t
        return self._over_S(out)

    def _sum_Kn2_eps(self) -> Posy:
        """sum_n (eps_n K_n)^2 — the negative ("-1") part of the exact
        participation-inflated q-block under a free cohort size."""
        eps = self._agg_eps
        v = self.vmap
        out = None
        for i in range(self.sys.N):
            w = 1.0 if eps is None else float(eps[i]) ** 2
            t = w * (v.Kn[i] ** 2)
            out = t if out is None else out + t
        return out

    # -- convergence-error constraint per m ----------------------------------
    @functools.cached_property
    def _conv_static(self) -> Dict[str, Posy]:
        """The expansion-point-independent pieces of the convergence block.

        A GIA iteration's coefficient refresh then only condenses the
        cached denominators at the new point (AM-GM / Taylor scalars) and
        performs a handful of monomial divisions — no posynomial-algebra
        rebuild in the hot loop.
        """
        c1, c2, c3, c4 = self._c_eff
        v = self.vmap
        Cmax = self.C_max
        sumK = self._sum_Kn()
        sumQ = self._sum_q_Kn2()
        st = {"sumK": sumK}

        # Free cohort size: the exact inflated q-block is a signomial
        # (positive part sumQ/S, negative part -sum (eps K)^2), so the
        # C/J/D constraints are multiplied through by sum_n eps_n K_n and
        # kept as a num/den ratio — the negative part lands in the
        # denominator, which ratio_to_posy AM-GM-condenses per iteration
        # exactly as m=E's (31) always has.  No bound relaxation.
        fs = self._i_S is not None

        if self.m is Objective.CONSTANT:                    # (26)
            g = self.gamma
            if fs:
                st["fs_num"] = (c1 / (Cmax * g)) / v.K0 \
                    + (c2 * g**2 / Cmax) * ((v.T2 ** 2) * sumK) \
                    + self._over_S((c3 * g / Cmax) * (sumK / v.B)) \
                    + (c4 * g / Cmax) * sumQ
                st["fs_den"] = sumK \
                    + (c4 * g / Cmax) * self._sum_Kn2_eps()
            else:
                st["overM_head"] = (c1 / (Cmax * g)) / v.K0
                st["mid"] = (c2 * g**2 / Cmax) * (v.T2 ** 2) \
                    + self._over_S((c3 * g / Cmax) / v.B)
                st["overM_tail"] = (c4 * g / Cmax) * sumQ
        elif self.m is Objective.JOINT:                     # (40)
            gam = v.extra
            if fs:
                st["fs_num"] = (c1 / Cmax) / (gam * v.K0) \
                    + (c2 / Cmax) * ((gam ** 2) * ((v.T2 ** 2) * sumK)) \
                    + self._over_S((c3 / Cmax) * (gam * (sumK / v.B))) \
                    + (c4 / Cmax) * (gam * sumQ)
                st["fs_den"] = sumK \
                    + (c4 / Cmax) * (gam * self._sum_Kn2_eps())
            else:
                st["overM_head"] = (c1 / Cmax) / (gam * v.K0)
                st["mid"] = (c2 / Cmax) * (gam ** 2) * (v.T2 ** 2) \
                    + self._over_S((c3 / Cmax) * gam / v.B)
                st["overM_tail"] = (c4 / Cmax) * (gam * sumQ)
            # (39): gamma <= 1/L  (lower bound comes from the box)
            st["gamma_cap"] = float(self.consts.L) * gam
        elif self.m is Objective.DIMINISHING:               # (35)
            g, rho = self.gamma, self.rho
            b1 = 1.0 / (rho * g)
            b2 = rho**2 * g**2 / (rho + 1.0)**3 \
                + rho**2 * g**2 / (2 * (rho + 1.0)**2)
            b3 = rho * g / (rho + 1.0)**2 + rho * g / (rho + 1.0)
            if fs:
                st["fs_num"] = const(b1 * c1, v.n) \
                    + (b2 * c2) * ((v.T2 ** 2) * sumK) \
                    + self._over_S((b3 * c3) * (sumK / v.B)) \
                    + (b3 * c4) * sumQ
                # scaled by the Taylor(K0) scalars b / a at each refresh
                st["fs_numB"] = Cmax * sumK
                st["fs_denK"] = Cmax * (v.K0 * sumK)
                st["fs_denQ"] = (b3 * c4) * self._sum_Kn2_eps()
            else:
                st["overM_head"] = const(b1 * c1, v.n)
                st["mid"] = b2 * c2 * (v.T2 ** 2) \
                    + self._over_S((b3 * c3) / v.B)
                st["overM_tail"] = b3 * c4 * sumQ
        elif self.m is Objective.EXPONENTIAL:               # (31)-(33)
            g, rho = self.gamma, self.rho
            a1 = (1.0 - rho) / g
            a2 = g**2 / (1.0 + rho + rho**2)
            a3 = g / (1.0 + rho)
            X0 = v.extra
            st["num"] = const(a1 * c1, v.n) \
                + (a2 * c2) * (v.T2 ** 2) * sumK \
                + self._over_S((a3 * c3) * (sumK / v.B)) \
                + Cmax * (X0 * sumK) \
                + a3 * c4 * sumQ
            st["den"] = Cmax * sumK \
                + (a2 * c2) * (v.T2 ** 2) * (X0 ** 3) * sumK \
                + self._over_S((a3 * c3) * ((X0 ** 2) * sumK / v.B)) \
                + (a3 * c4) * (X0 ** 2) * sumQ
            if fs:
                # exact inflated q-block: the -sum (eps K)^2 parts of num
                # and den each move across the inequality to stay posynomial
                sumQm = self._sum_Kn2_eps()
                st["num"] = st["num"] + (a3 * c4) * ((X0 ** 2) * sumQm)
                st["den"] = st["den"] + (a3 * c4) * sumQm
            lam = float(np.log(1.0 / rho))
            st["lam"] = lam
            st["lam_X0K0"] = lam * (X0 * v.K0)
            st["lam_K0"] = lam * v.K0
            # (30): X0 < 1 (strict; use 1 - eps)
            st["x0_cap"] = X0 * (1.0 / (1.0 - 1e-9))
        else:
            raise ValueError(self.m)
        return st

    def _conv_constraint(self, z_prev: np.ndarray) -> List[Posy]:
        v = self.vmap
        Cmax = self.C_max
        st = self._conv_static
        fs = self._i_S is not None

        if fs and self.m in (Objective.CONSTANT, Objective.JOINT):
            con = ratio_to_posy(st["fs_num"], st["fs_den"], z_prev)
            return [con] if self.m is Objective.CONSTANT \
                else [con, st["gamma_cap"]]
        if fs and self.m is Objective.DIMINISHING:
            rho = self.rho
            K0_prev = float(np.exp(z_prev @ v.K0.A[0]) * v.K0.c[0])
            a = float(np.log((K0_prev + rho + 1.0) / (rho + 1.0))
                      + K0_prev / (K0_prev + rho + 1.0))
            b = float(K0_prev**2 / (K0_prev + rho + 1.0))
            num = st["fs_num"] + b * st["fs_numB"]
            den = a * st["fs_denK"] + st["fs_denQ"]
            return [ratio_to_posy(num, den, z_prev)]

        if self.m is not Objective.EXPONENTIAL:
            M = amgm_monomial(st["sumK"], z_prev)  # condensed sum_n K_n

        if self.m in (Objective.CONSTANT, Objective.JOINT):  # (26) / (40)
            con = st["overM_head"] / M + st["mid"] + st["overM_tail"] / M
            return [con] if self.m is Objective.CONSTANT \
                else [con, st["gamma_cap"]]

        if self.m is Objective.DIMINISHING:                 # (35)
            rho = self.rho
            K0_prev = float(np.exp(z_prev @ v.K0.A[0]) * v.K0.c[0])
            # RHS phi(K0) = K0 log((K0+rho+1)/(rho+1)) is convex; Taylor lower
            # bound a*K0 - b tightens the constraint (inner approximation).
            a = float(np.log((K0_prev + rho + 1.0) / (rho + 1.0))
                      + K0_prev / (K0_prev + rho + 1.0))
            b = float(K0_prev**2 / (K0_prev + rho + 1.0))
            lhs = st["overM_head"] / M + st["mid"] \
                + st["overM_tail"] / M + b * Cmax
            return [lhs / ((Cmax * a) * v.K0)]

        if self.m is Objective.EXPONENTIAL:                 # (31)-(33)
            X0 = v.extra
            cons = [ratio_to_posy(st["num"], st["den"], z_prev)]
            # (28)/(29) sandwich X0 = rho^{K0}.  The Taylor surrogates (32),
            # (33) are *active* at a consistent expansion point, so we relax
            # each by a small margin delta to keep a strict interior for the
            # barrier method (the exact equality is re-imposed by
            # ``project_expansion`` every GIA iteration, and the final point
            # is validated with the true C_E).
            delta = np.exp(-3e-3)
            # (28) -> (32):  X0 log(1/X0) <= X0 K0 log(1/rho)
            X0_prev = float(np.exp(z_prev @ X0.A[0]) * X0.c[0])
            lam = st["lam"]
            a_t, b_t = taylor_xlog1x(X0_prev)
            # (a_t X0 + b_t) <= X0 K0 lam  ==>  move negative a_t if needed
            if a_t >= 0:
                lhs32 = a_t * X0 + const(b_t, v.n)
                den32 = st["lam_X0K0"]
            else:
                lhs32 = const(b_t, v.n)
                den32 = st["lam_X0K0"] + (-a_t) * X0
            cons.append(ratio_to_posy(lhs32, den32, z_prev) * delta)
            # (29) -> (33):  K0 log(1/rho) <= log(1/X0); use the affine upper
            # bound log(X0) <= aX*X0 + bX  ==>  K0 lam + aX X0 + bX <= 0
            aX, bX = taylor_logx(X0_prev)
            rhs = -bX  # = 1 + log(1/X0_prev) > 0 since X0_prev < 1
            assert rhs > 0
            cons.append(((st["lam_K0"] + aX * X0) / rhs) * delta)
            cons.append(st["x0_cap"])                       # (30): X0 < 1
            return cons

        raise ValueError(self.m)

    # -- structure / coefficient split ----------------------------------------
    # The GP sequence of one problem shares a fixed *skeleton*: the objective
    # and the common constraints (22)-(24) + box bounds never depend on the
    # expansion point.  Only the convergence-error block (the condensed /
    # Taylor surrogates) is refreshed per GIA iteration, which is what the
    # batched engine (repro.opt.structure + repro.opt.gp backends) exploits.
    @functools.cached_property
    def skeleton(self) -> Tuple[Posy, Tuple[Posy, ...]]:
        """(objective, common constraints) — the z-independent GP parts."""
        return self._objective(), tuple(self._common_constraints())

    @functools.cached_property
    def packed_skeleton(self) -> Tuple[np.ndarray, np.ndarray]:
        """The common constraints concatenated to flat ``(log c, A)`` arrays
        — computed once per problem, reused by every batched-solver pack."""
        _, common = self.skeleton
        logc = np.concatenate([np.log(c.c) for c in common])
        A = np.concatenate([c.A for c in common], axis=0)
        return logc, A

    def conv_block(self, z_prev: np.ndarray) -> List[Posy]:
        """The expansion-point-dependent convergence-error constraints.

        ``z_prev`` must already be a consistent expansion point (see
        :meth:`project_expansion`).
        """
        return self._conv_constraint(z_prev)

    # -- public API -----------------------------------------------------------
    def build(self, z_prev: np.ndarray) -> GP:
        """The iteration-t approximate GP (Problems 4 / 6 / 8 / 12)."""
        z_prev = self.project_expansion(z_prev)
        obj, common = self.skeleton
        return GP(obj, list(common) + self.conv_block(z_prev))

    def project_expansion(self, z: np.ndarray) -> np.ndarray:
        """Make the expansion point consistent before building surrogates.

        For m=E the constraints (28)/(29) sandwich X0 = rho^{K0}; Taylor
        surrogates built at an inconsistent point have (near-)empty interiors,
        so we re-impose the equality exactly at every expansion.
        """
        if self.m is not Objective.EXPONENTIAL:
            return z
        z = z.copy()
        v = self.vmap
        i_x0 = v.names.index("extra")
        K0 = float(np.exp(v.K0.logvalue(z)))
        z[i_x0] = K0 * np.log(self.rho)
        return z

    # the K0 search ladder of z_init: the 1.5x growth sequence the historical
    # per-point loop walked, precomputed (64 rungs reach ~1.1e11 rounds)
    _K0_LADDER = None

    @classmethod
    def _k0_ladder(cls) -> np.ndarray:
        if cls._K0_LADDER is None:
            ks = [1]
            while len(ks) < 64:
                ks.append(int(np.ceil(ks[-1] * 1.5)))
            cls._K0_LADDER = np.asarray(ks, dtype=np.float64)
        return cls._K0_LADDER

    def _grid_CTE(self, ks: np.ndarray, Kn: np.ndarray, B: np.ndarray,
                  gam_arr: Optional[np.ndarray],
                  S0: Optional[float] = None):
        """C/T/E surfaces over (grid point, K0 ladder) — evaluated with the
        very same :mod:`repro.core` closed forms :meth:`evaluate` uses
        (they broadcast over the ladder axis), so the feasibility search
        can never drift from the true cost model.  ``S0`` prices the
        surfaces at a concrete cohort size (free-S problems only)."""
        from ..core import convergence as conv
        from ..core.cost import energy_cost, time_cost
        c, qp = self._conv_coeffs(S0)
        pi = self._pi_at(S0)
        eps = self._agg_eps
        G, L = Kn.shape[0], ks.shape[0]
        C = np.empty((G, L))
        T = np.empty((G, L))
        E = np.empty((G, L))
        for g in range(G):
            if self.m is Objective.EXPONENTIAL:
                C[g] = conv.c_exponential(ks, Kn[g], B[g], self.gamma,
                                          self.rho, c, qp, eps)
            elif self.m is Objective.DIMINISHING:
                C[g] = conv.c_diminishing(ks, Kn[g], B[g], self.gamma,
                                          self.rho, c, qp, eps)
            else:   # CONSTANT, or JOINT at the grid's trial gamma
                gam = (gam_arr[g] if self.m is Objective.JOINT
                       else self.gamma)
                C[g] = conv.c_constant(ks, Kn[g], B[g], gam, c, qp, eps)
            T[g] = time_cost(self.sys, ks, Kn[g], B[g], worst_case=True)
            E[g] = energy_cost(self.sys, ks, Kn[g], B[g], pi=pi)
        return C, T, E

    def z_init(self) -> np.ndarray:
        """Find a *feasible* starting point of the original problem
        (Algorithms 2-5, line 1: "choose any feasible solution").

        Searches a small grid over the integer-ish actual variables and picks
        the smallest K0 restoring C <= C_max (C_m is non-increasing in K0).
        The whole (grid x K0-ladder) search evaluates the closed-form
        C/T/E surfaces as one broadcast NumPy computation; selection
        semantics (ladder walk, first C-feasible rung, first-wins energy
        ties) match the historical per-point loop.
        """
        v = self.vmap
        names = v.names
        z = np.zeros(v.n)
        gamma_grid = ([None] if self.m is not Objective.JOINT
                      else [0.5 / self.consts.L, 0.1 / self.consts.L,
                            0.01 / self.consts.L, 1.0 / self.consts.L])
        B_grid = (1, 2, 4, 8, 16, 32, 64, 128)
        K_grid = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
        combos = [(gam, Bv, Kv) for gam in gamma_grid for Bv in B_grid
                  for Kv in K_grid]
        G = len(combos)
        ZC = np.zeros((G, v.n))
        for i, nm in enumerate(names):
            if nm.startswith("K") and nm != "K0" or nm == "l":
                ZC[:, i] = np.log([float(Kv) for _, _, Kv in combos])
            elif nm == "B":
                ZC[:, i] = np.log([float(Bv) for _, Bv, _ in combos])
            elif nm == "extra" and self.m is Objective.JOINT:
                ZC[:, i] = np.log([gam for gam, _, _ in combos])
        # paper variables at every grid point via the monomial map
        Kn = np.stack([np.exp(_log_posy_batch(k, ZC)) for k in v.Kn], axis=1)
        B = np.exp(_log_posy_batch(v.B, ZC))                       # (G,)
        gam_arr = (np.array([g for g, _, _ in combos])
                   if self.m is Objective.JOINT else None)
        ks = self._k0_ladder()                                     # (L,)
        L = ks.shape[0]
        # free-S problems search a halving ladder of cohort sizes too: the
        # local GIA polishes within the basin this seed lands in, so the
        # seed must compare S levels globally (the energy-optimal cohort
        # can sit far below the cap)
        if self._i_S is None:
            S_levels = [None]
        else:
            cap = max(1.0, float(np.floor(
                self.sampling.s_cap(self.sys.N) + 1e-9)))
            S_levels, sv = [], cap
            while True:
                S_levels.append(sv)
                if sv <= 1.0:
                    break
                sv = float(np.ceil(sv / 2.0))
        best = None                    # (E, g, first_c rung, S level)
        for S0 in S_levels:
            C, T, E = self._grid_CTE(ks, Kn, B, gam_arr, S0)       # (G, L)
            c_ok = C <= self.C_max * (1 - 1e-3)                    # (G, L)
            t_viol = T > self.T_max
            first_c = np.where(c_ok.any(axis=1), c_ok.argmax(axis=1), L)
            first_t = np.where(t_viol.any(axis=1), t_viol.argmax(axis=1), L)
            # the ladder walk stops at whichever comes first; C wins ties
            # (the loop checked C before the time break at each rung)
            hit = (first_c < L) & (first_c <= first_t)
            idx = np.where(hit, np.minimum(first_c, L - 1), 0)
            ok = hit & (T[np.arange(G), idx] <= self.T_max * (1 - 1e-3))
            if ok.any():
                E_hit = np.where(ok, E[np.arange(G), idx], np.inf)
                g_best = int(E_hit.argmin())           # first-wins ties
                if best is None or E_hit[g_best] < best[0]:
                    best = (float(E_hit[g_best]), g_best,
                            int(first_c[g_best]), S0)
        if best is not None:
            _, g_best, rung, S_sel = best
            gam, Bv, Kv = combos[g_best]
            K0 = int(ks[rung])
        else:  # no feasible grid point; fall back to a benign interior guess
            K0, Kv, Bv, gam = 64, 4, 4, (0.1 / self.consts.L
                                         if self.m is Objective.JOINT else None)
            S_sel = S_levels[0]
        for i, nm in enumerate(names):
            if nm == "K0":
                z[i] = np.log(float(K0))
            elif nm.startswith("K") or nm == "l":
                z[i] = np.log(float(Kv))
            elif nm == "B":
                z[i] = np.log(float(Bv))
            elif nm == "extra" and self.m is Objective.JOINT:
                z[i] = np.log(gam)
        if self._i_S is not None:          # seed at the grid-best cohort size
            z[self._i_S] = np.log(float(S_sel))
        Kn = np.array([float(np.exp(k.logvalue(z))) for k in v.Kn])
        ct = self.sys.comp_time_coeff_wc
        if "T1" in names:  # keep (22)/(23) strictly slack at the start
            z[names.index("T1")] = float(np.log(np.max(ct * Kn) * 1.5))
        if "T2" in names:
            z[names.index("T2")] = float(np.log(np.max(Kn) * 1.5))
        return self.project_expansion(z)

    # -- true (non-approximate) evaluation ------------------------------------
    def evaluate(self, K0: float, Kn: np.ndarray, B: float,
                 extra: Optional[float] = None,
                 S: Optional[float] = None) -> Dict[str, float]:
        """Closed-form (C, T, E) at a concrete point.  ``S`` is required
        (and only meaningful) when the cohort size is a free variable;
        ``E`` is then the *expected* energy over cohort draws."""
        from ..core import convergence as conv
        from ..core.cost import energy_cost, time_cost
        c, qp = self._conv_coeffs(S)
        eps = self._agg_eps
        if self.m is Objective.CONSTANT:
            C = conv.c_constant(K0, Kn, B, self.gamma, c, qp, eps)
        elif self.m is Objective.EXPONENTIAL:
            C = conv.c_exponential(K0, Kn, B, self.gamma, self.rho, c, qp,
                                   eps)
        elif self.m is Objective.DIMINISHING:
            C = conv.c_diminishing(K0, Kn, B, self.gamma, self.rho, c, qp,
                                   eps)
        elif self.m is Objective.JOINT:
            assert extra is not None
            C = conv.c_constant(K0, Kn, B, extra, c, qp, eps)
        return {
            "E": energy_cost(self.sys, K0, Kn, B, pi=self._pi_at(S)),
            "T": time_cost(self.sys, K0, Kn, B, worst_case=True),
            "C": C,
        }

    def feasible(self, K0, Kn, B, extra=None, rtol: float = 1e-6,
                 S: Optional[float] = None) -> bool:
        ev = self.evaluate(K0, np.asarray(Kn, dtype=np.float64), B, extra,
                           S=S)
        ok = (ev["T"] <= self.T_max * (1 + rtol)
              and ev["C"] <= self.C_max * (1 + rtol))
        if self.m is Objective.JOINT and extra is not None:
            ok = ok and extra <= 1.0 / self.consts.L * (1 + rtol)
        return ok
