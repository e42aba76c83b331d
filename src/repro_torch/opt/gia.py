"""GIA outer loops — Algorithms 2, 3, 4, 5 — plus integer recovery.

``solve_param_opt`` runs the successive-GP refinement of a
:class:`~repro.opt.problems.ParamOptProblem` to a KKT point of the continuous
relaxation and then constructs a nearly-optimal integer point (the paper
relaxes K, B to reals and notes integer recovery is straightforward).

``solve_param_opt_batched`` is the same algorithm in lockstep over a batch of
instances sharing one structure signature (same objective m, family varmap,
worker count — e.g. one Fig.-5 sweep line): every outer iteration refreshes
all expansion-point coefficients and performs the whole batch's GP solves in
one :func:`~repro_torch.opt.gp.solve_gp_batch` call, with per-instance
convergence / stall masks freezing finished instances.
``backend="torch-fused"`` goes further and runs the *entire* outer loop —
coefficient refresh included — as one captured step program per structure
signature on the card (:mod:`repro_torch.opt.gia_fused`).

For m=J (Problem 11) both entry points finish with a Gen-C-seeded restart:
the companion constant-step problem is solved at a few canonical step sizes,
the joint GIA re-runs from each solved point (with log gamma appended), and
the best KKT point wins — the cold-started surrogate sequence can converge
to a point slightly above Gen-C's (Lemma 4 says joint optimization can only
help), and re-expanding around Gen-C's solution repairs exactly that.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import REGISTRY as _METRICS
from ..obs import trace as _trace
from ..obs.metrics import GLOBAL_SWITCH as _OBS_ON
from .gp import GPResult, refuse_jax_backend, solve_gp, solve_gp_batch
from .problems import Objective, ParamOptProblem
from .structure import GPStructure, structure_signature

__all__ = ["GIAResult", "solve_param_opt", "solve_param_opt_batched",
           "min_feasible_K0", "min_feasible_K0_joint"]


@dataclasses.dataclass
class GIAResult:
    converged: bool
    feasible: bool
    iterations: int
    z: np.ndarray                  # final log-space point (continuous)
    x: Dict[str, float]            # named continuous solution
    K0: int
    Kn: np.ndarray                 # integer per-worker local iterations
    B: int
    gamma: Optional[float]         # optimized step size (m="J" only)
    E: float                       # true energy cost at the integer point
    T: float
    C: float
    history: List[float]           # objective per GIA iteration
    S: Optional[int] = None        # cohort size (None = full participation)


def _extract(problem: ParamOptProblem, z: np.ndarray):
    v = problem.vmap
    K0 = float(np.exp(v.K0.logvalue(z)))
    Kn = np.array([float(np.exp(k.logvalue(z))) for k in v.Kn])
    B = float(np.exp(v.B.logvalue(z)))
    extra = float(np.exp(v.extra.logvalue(z))) if v.extra is not None else None
    i_S = problem._i_S
    S = float(np.exp(z[i_S])) if i_S is not None else None
    return K0, Kn, B, extra, S


def solve_param_opt(problem: ParamOptProblem,
                    z0: Optional[np.ndarray] = None,
                    tol: float = 1e-4, max_iter: int = 60,
                    verbose: bool = False,
                    joint_restart: bool = True) -> GIAResult:
    z = problem.z_init() if z0 is None else np.asarray(z0, dtype=np.float64)
    history: List[float] = []
    converged = False
    res: Optional[GPResult] = None
    stall = 0
    for it in range(max_iter):
        z = problem.project_expansion(z)
        gp = problem.build(z)
        res = solve_gp(gp, z)
        if not res.feasible:
            # The *approximate* problem can be infeasible away from a good
            # expansion point; the phase-I minimizer inside solve_gp is the
            # min-slack point — rebuild the surrogates there and retry.
            z = res.z
            stall += 1
            if stall > 8:
                break
            continue
        stall = 0
        # convergence is judged between successive *expansion points* — both
        # sides projected.  m=E's surrogates (32)/(33) hold X0 a delta-margin
        # off the X0 = rho^K0 manifold that project_expansion re-imposes, so
        # comparing the raw optimizer output against the projected input
        # bounces by exactly delta forever (historically 60 maxed-out
        # iterations with every other coordinate stable to 1e-13)
        step = float(np.max(np.abs(problem.project_expansion(res.z) - z)))
        z = res.z
        history.append(res.obj)
        if verbose:
            print(f"  GIA iter {it}: E={res.obj:.6g} step={step:.3g}")
        if step < tol:
            converged = True
            break
    result = _finalize(problem, z, history, converged)
    if joint_restart and problem.m is Objective.JOINT:
        for g in _joint_seed_gammas(problem, result):
            comp = _companion_constant(problem, g)
            rc = solve_param_opt(comp, tol=tol, max_iter=max_iter)
            zw = rc.z.copy()
            zw[problem.vmap.names.index("extra")] = np.log(g)
            warm = solve_param_opt(problem, z0=zw, tol=tol,
                                   max_iter=max_iter, joint_restart=False)
            result = _better_kkt(result, warm)
    return result


def _record_solve(backend: str, n_rows: int, results: List["GIAResult"],
                  pad_to: int) -> None:
    """Per-dispatch solver metrics (host-side only; inert when obs is off).

    Each GIA iteration refreshes the surrogate coefficients once, so
    ``GIAResult.iterations`` doubles as the per-row refresh count.
    """
    if not _OBS_ON.on:
        return
    _METRICS.counter("gia.rows_solved", backend=backend).inc(n_rows)
    _METRICS.histogram("gia.batch_rows", backend=backend).observe(n_rows)
    _METRICS.histogram("gia.batch_occupancy", backend=backend).observe(
        n_rows / max(int(pad_to), n_rows))
    it_h = _METRICS.histogram("gia.iterations_per_row", backend=backend)
    refreshes = 0
    for r in results:
        it_h.observe(r.iterations)
        refreshes += r.iterations
    _METRICS.counter("gia.refreshes", backend=backend).inc(refreshes)


def solve_param_opt_batched(problems: Sequence[ParamOptProblem],
                            z0s: Optional[Sequence[Optional[np.ndarray]]]
                            = None,
                            tol: float = 1e-4, max_iter: int = 60,
                            backend: str = "torch",
                            verbose: bool = False,
                            joint_restart: bool = True,
                            pad_to: int = 0,
                            device="cuda") -> List[GIAResult]:
    """Lockstep-batched ``solve_param_opt`` over same-structure instances.

    Per-instance semantics match the scalar loop exactly: each instance sees
    the same sequence of expansion points, phase-I retries, and stall exits
    it would see standalone (the ``backend="numpy"`` path is bit-identical
    row-for-row, on the host); ``backend="torch"`` performs each iteration's
    GP solves in one batched interior-point call on ``device``;
    ``backend="torch-fused"`` runs the whole outer loop — surrogate refresh
    included — as one captured step program per structure signature on
    ``device`` (:mod:`repro_torch.opt.gia_fused`; nothing to print per
    iteration, so ``verbose`` is a no-op there).  ``"jnp"`` and
    ``"jnp-fused"`` raise ``ValueError`` naming these counterparts.

    ``z0s`` warm-starts individual rows: entries are starting points in
    log-space, or ``None`` for that row's cold ``z_init()`` — warm and cold
    rows mix freely inside one batch (a row warm-started at a previously
    solved KKT point re-converges in 1-3 GIA iterations instead of running
    cold phase-I).  ``pad_to`` (fused backend only) pads the device batch to
    a fixed row count so variable-size micro-batches of one signature share
    a single captured program; padding rows are discarded before the m=J
    restart and never finalized.
    """
    refuse_jax_backend(backend)
    problems = list(problems)
    if not problems:
        return []
    sig = structure_signature(problems[0])
    for p in problems[1:]:
        if structure_signature(p) != sig:
            raise ValueError(
                f"batched GIA needs one structure signature, got both {sig} "
                f"and {structure_signature(p)}; group instances by "
                f"(m, family, N) first")
    B = len(problems)
    if z0s is None:
        zs = [p.z_init() for p in problems]
    else:
        zs = [p.z_init() if z is None
              else np.asarray(z, dtype=np.float64).copy()
              for p, z in zip(problems, z0s)]
    _t0 = time.perf_counter() if _OBS_ON.on else 0.0
    if backend == "torch-fused":
        from .gia_fused import solve_gia_fused
        results = [
            _finalize(p, np.asarray(z, dtype=np.float64), history, conv)
            for p, (z, history, conv)
            in zip(problems, solve_gia_fused(problems, zs, tol, max_iter,
                                             pad_to=pad_to, device=device))]
        if _OBS_ON.on:
            _trace.add_span("gia.solve", _t0, time.perf_counter(),
                            backend=backend, rows=B,
                            m=str(problems[0].m.value))
            _record_solve(backend, B, results, pad_to)
        if joint_restart and problems[0].m is Objective.JOINT:
            results = _joint_restart_batched(problems, results, tol,
                                             max_iter, backend,
                                             pad_to=pad_to, device=device)
        return results
    structure = GPStructure(problems[0])
    history: List[List[float]] = [[] for _ in range(B)]
    converged = [False] * B
    active = [True] * B
    stall = [0] * B
    for it in range(max_iter):
        if not any(active):
            break
        pack = structure.pack_batch(problems, zs, active=active)
        # projected expansion points (inactive rows keep their final z —
        # their pack rows are stale placeholders the backends skip)
        zs = [pack.z0[i] if active[i] else zs[i] for i in range(B)]
        res = solve_gp_batch(pack, backend=backend, device=device)
        for i in range(B):
            if not active[i]:
                continue
            if not res.feasible[i]:
                zs[i] = res.z[i]                # retry from min-slack point
                stall[i] += 1
                if stall[i] > 8:
                    active[i] = False
                continue
            stall[i] = 0
            # projected-vs-projected step, as in the scalar loop
            step = float(np.max(np.abs(
                problems[i].project_expansion(res.z[i]) - zs[i])))
            zs[i] = res.z[i]
            history[i].append(float(res.obj[i]))
            if verbose:
                print(f"  GIA[{i}] iter {it}: E={res.obj[i]:.6g} "
                      f"step={step:.3g}")
            if step < tol:
                converged[i] = True
                active[i] = False
    results = [_finalize(p, np.asarray(zs[i], dtype=np.float64), history[i],
                         converged[i])
               for i, p in enumerate(problems)]
    if _OBS_ON.on:
        _trace.add_span("gia.solve", _t0, time.perf_counter(),
                        backend=backend, rows=B, m=str(problems[0].m.value))
        _record_solve(backend, B, results, pad_to=0)
    if joint_restart and problems[0].m is Objective.JOINT:
        results = _joint_restart_batched(problems, results, tol, max_iter,
                                         backend, device=device)
    return results


# ---------------------------------------------------------------------------
# m=J Gen-C-seeded restart (Lemma 4 guard)
# ---------------------------------------------------------------------------
#: canonical companion step sizes, as fractions of the 1/L cap — 1e-3/L sits
#: in the regime the paper's Sec.-VII constant rules operate in
_JOINT_SEED_FRACS = (1e-3,)


def _joint_seed_gammas(problem: ParamOptProblem, cold: GIAResult
                       ) -> List[float]:
    """Candidate fixed step sizes for the companion m=C solves: the cold
    joint solution's gamma plus the canonical fractions of 1/L, clipped to
    (0, 1/L] and de-duplicated."""
    cap = 1.0 / float(problem.consts.L)
    raw = ([] if cold.gamma is None or not np.isfinite(cold.gamma)
           or cold.gamma <= 0 else [float(cold.gamma)])
    raw += [f * cap for f in _JOINT_SEED_FRACS]
    out: List[float] = []
    for g in raw:
        g = min(max(g, 1e-12), cap)
        if all(abs(g / g0 - 1.0) > 1e-6 for g0 in out):
            out.append(g)
    return out


def _companion_constant(problem: ParamOptProblem, g: float) -> ParamOptProblem:
    """The m=C companion of a joint problem at fixed gamma, on the *same*
    varmap — the gamma variable stays as an unconstrained-but-boxed spectator
    so the structure signature is shared by every companion in a batch."""
    return dataclasses.replace(problem, m=Objective.CONSTANT, gamma=float(g))


def _better_kkt(a: GIAResult, b: GIAResult) -> GIAResult:
    """Prefer feasible, then lower true energy; ties keep the incumbent."""
    if a.feasible != b.feasible:
        return a if a.feasible else b
    return b if b.E < a.E else a


def _joint_restart_batched(problems: Sequence[ParamOptProblem],
                           colds: List[GIAResult], tol: float, max_iter: int,
                           backend: str, pad_to: int = 0,
                           device="cuda") -> List[GIAResult]:
    """Batched counterpart of the scalar restart in :func:`solve_param_opt`:
    one batched companion solve + one batched warm re-solve per seed round
    (companions share a signature, so each round stays two program runs;
    ``pad_to`` keeps both at the caller's fixed batch shape).
    """
    i_ex = problems[0].vmap.names.index("extra")
    cands = [_joint_seed_gammas(p, r) for p, r in zip(problems, colds)]
    best = list(colds)
    for j in range(max(len(c) for c in cands)):
        idxs = [i for i, c in enumerate(cands) if len(c) > j]
        comps = [_companion_constant(problems[i], cands[i][j]) for i in idxs]
        rcs = solve_param_opt_batched(comps, tol=tol, max_iter=max_iter,
                                      backend=backend, pad_to=pad_to,
                                      device=device)
        z0s = []
        for i, rc in zip(idxs, rcs):
            zw = rc.z.copy()
            zw[i_ex] = np.log(cands[i][j])
            z0s.append(zw)
        warms = solve_param_opt_batched([problems[i] for i in idxs], z0s=z0s,
                                        tol=tol, max_iter=max_iter,
                                        backend=backend, joint_restart=False,
                                        pad_to=pad_to, device=device)
        for i, w in zip(idxs, warms):
            best[i] = _better_kkt(best[i], w)
    return best



def _finalize(problem: ParamOptProblem, z: np.ndarray,
              history: List[float], converged: bool) -> GIAResult:
    """Integer recovery + true-constraint evaluation at the continuous point."""
    _, _, _, extra, _ = _extract(problem, z)
    K0i, Kni, Bi, extra_i, Si, _ = _round_integer(problem, z, extra)
    ev = problem.evaluate(K0i, Kni, Bi, extra_i, S=Si)
    v = problem.vmap
    named = {name: float(np.exp(z[i])) for i, name in enumerate(v.names)}
    # pinned-cohort models have no S variable; report their fixed size so
    # Plan plumbing is uniform (None stays the full-participation marker)
    S_out = Si if Si is not None \
        else problem.sampling.pinned_S(problem.sys.N)
    return GIAResult(
        converged=converged,
        feasible=problem.feasible(K0i, Kni, Bi, extra_i, S=Si),
        iterations=len(history), z=z, x=named,
        K0=K0i, Kn=Kni, B=Bi,
        gamma=extra_i if problem.m is Objective.JOINT else problem.gamma,
        E=ev["E"], T=ev["T"], C=ev["C"], history=list(history), S=S_out)


def min_feasible_K0(problem: ParamOptProblem, Kn, B,
                    extra: Optional[float] = None, K0_lo: int = 1,
                    ctol: float = 1e-9, ttol: float = 1e-9,
                    max_doublings: int = 200, S: Optional[int] = None):
    """Smallest integer ``K0 >= K0_lo`` with ``C(K0) <= C_max*(1+ctol)``.

    ``C_m`` is non-increasing and ``T`` non-decreasing in ``K0``, so the
    search is exponential bracketing plus monotone bisection (~2 log2(K0*)
    ``evaluate`` calls); a bracket point that already blows the time budget
    while C is still unmet certifies infeasibility.  Returns ``(K0, ok)``
    where ``ok`` additionally requires ``T(K0) <= T_max*(1+ttol)``.
    """
    C_cap = problem.C_max * (1 + ctol)
    T_cap = problem.T_max * (1 + ttol)
    ev = problem.evaluate(K0_lo, Kn, B, extra, S=S)
    if ev["C"] <= C_cap:
        return K0_lo, ev["T"] <= T_cap
    lo, hi = K0_lo, K0_lo
    for _ in range(max_doublings):
        if ev["T"] > problem.T_max:
            return hi, False            # time budget dies before C is met
        lo, hi = hi, hi * 2
        ev = problem.evaluate(hi, Kn, B, extra, S=S)
        if ev["C"] <= C_cap:
            break
    else:
        return hi, False
    # invariant: C(lo) > C_cap >= C(hi); bisect to the smallest C-ok K0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if problem.evaluate(mid, Kn, B, extra, S=S)["C"] <= C_cap:
            hi = mid
        else:
            lo = mid
    return hi, problem.evaluate(hi, Kn, B, extra, S=S)["T"] <= T_cap


def min_feasible_K0_joint(problem: ParamOptProblem, Kn, B, K0_lo: int = 1,
                          ctol: float = 1e-9, ttol: float = 1e-9,
                          S: Optional[int] = None):
    """m=J integer recovery: smallest ``K0 >= K0_lo`` whose *gamma-optimized*
    error meets the budget, ``min_gamma C(K0, gamma) <= C_max*(1+ctol)``.

    Closed form, no scan: for fixed parameters the constant-rule error is
    ``C(K0, g) = a/(g K0) + b g^2 + c g`` with a, b, c >= 0, so three probes
    of the *true* closed form at K0=1 recover the coefficients (no formula
    duplicated from :mod:`repro.core`), feasibility inverts to
    ``K0 >= a / (g C_cap - b g^3 - c g^2)``, and the denominator's maximum
    over the Lemma-4 interval ``(0, 1/L]`` is a quadratic root.  Returns
    ``(K0, gamma, ok)`` — fixing gamma at the continuous optimizer's value
    can round to a worse integer point than a neighbouring (Kn, B) allows;
    re-optimizing the step size per candidate is what keeps Gen-O
    at-or-below every fixed-rule baseline.
    """
    C_cap = problem.C_max * (1 + ctol)
    T_cap = problem.T_max * (1 + ttol)
    probes = (0.5, 1.0, 2.0)
    Cs = np.array([problem.evaluate(1, Kn, B, g, S=S)["C"] for g in probes])
    M = np.array([[1.0 / g, g * g, g] for g in probes])
    a, b, c = np.linalg.solve(M, Cs)
    L_cap = 1.0 / float(problem.consts.L)
    # argmax of slack(g) = C_cap*g - b*g^3 - c*g^2 on (0, L_cap]
    if b > 1e-300:
        g = (-c + math.sqrt(c * c + 3.0 * b * C_cap)) / (3.0 * b)
    elif c > 1e-300:
        g = C_cap / (2.0 * c)
    else:
        g = L_cap
    g = min(g, L_cap)
    slack = g * C_cap - b * g ** 3 - c * g ** 2
    if slack <= 0.0:
        return K0_lo, g, False
    K0 = max(K0_lo, int(math.ceil(a / slack - 1e-12)))
    while problem.evaluate(K0, Kn, B, g, S=S)["C"] > C_cap:   # fp guard
        K0 += 1
    return K0, g, problem.evaluate(K0, Kn, B, g, S=S)["T"] <= T_cap


def _round_S(problem: ParamOptProblem, Sf: Optional[float], mode=round
             ) -> Optional[int]:
    """Integer cohort size clamped to ``[1, floor(s_cap)]`` — rounding can
    never push an inclusion probability above 1.  None stays None."""
    if Sf is None:
        return None
    s_hi = int(math.floor(problem.sampling.s_cap(problem.sys.N) + 1e-9))
    return min(max(1, int(mode(Sf))), max(1, s_hi))


#: uniform integer candidate grids of the m=J polish (z_init's search grids
#: plus the in-between K values integer recovery actually lands on)
_POLISH_B_GRID = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128)
_POLISH_K_GRID = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32)


def _joint_integer_polish(problem: ParamOptProblem, z: np.ndarray, best):
    """m=J global integer fallback: sweep uniform (Kn, B) grid points near
    the continuous optimum with gamma-optimized K0 recovery.

    Rounding the continuous joint optimizer can land in a worse integer
    basin than a neighbouring (Kn, B) — the step size re-optimizes around
    any integer point, so the paper's "integer recovery is straightforward"
    needs candidates beyond the componentwise roundings for Gen-O to stay
    at-or-below every fixed-rule baseline.  Candidates are built in the
    *actual* variable space (family ties respected) and pruned to a
    work-product band around the continuous point.
    """
    v = problem.vmap
    _, Knf, Bf, _, Sf = _extract(problem, z)
    Si = _round_S(problem, Sf)
    prod = float(max(np.mean(Knf) * Bf, 1.0))
    seen = set()
    for Bv in _POLISH_B_GRID:
        for Kv in _POLISH_K_GRID:
            zc = z.copy()
            for i, nm in enumerate(v.names):
                if (nm.startswith("K") and nm != "K0") or nm == "l":
                    zc[i] = np.log(float(Kv))
                elif nm == "B":
                    zc[i] = np.log(float(Bv))
            _, Knf_c, Bf_c, _, _ = _extract(problem, zc)
            Kni = np.maximum(1, np.round(Knf_c)).astype(np.int64)
            Bi = max(1, int(round(Bf_c)))
            key = (tuple(Kni.tolist()), Bi)
            if key in seen:
                continue
            seen.add(key)
            if not prod / 3.0 <= float(np.mean(Kni)) * Bi <= prod * 3.0:
                continue
            K0i, g, ok = min_feasible_K0_joint(problem, Kni, Bi, S=Si)
            if not ok:
                continue
            ev = problem.evaluate(K0i, Kni, Bi, g, S=Si)
            if best is None or ev["E"] < best[5]:
                best = (K0i, Kni, Bi, g, Si, ev["E"])
    return best


def _round_integer(problem: ParamOptProblem, z: np.ndarray,
                   extra: Optional[float]):
    """Construct a feasible integer (K0, Kn, B) near the continuous optimum.

    Rounding happens in the *actual* variable space (so baselines with tied
    variables — e.g. FedAvg's K_n = l·I_n/B — keep their structure), then the
    paper variables are re-derived from the monomial map.  C_m is
    non-increasing in K0 for every rule, so each rounding takes the smallest
    K0 restoring C <= C_max (via :func:`min_feasible_K0` bisection — for m=J
    the gamma-optimizing :func:`min_feasible_K0_joint`) and the least-energy
    feasible candidate wins.  Returns ``(K0, Kn, B, extra, S, E)`` with
    ``extra`` the (re-optimized, for m=J) step size / X0 value and ``S``
    the rounded cohort size (None without a free sampling variable).
    """
    v = problem.vmap
    joint = problem.m is Objective.JOINT
    int_idx = [i for i, nm in enumerate(v.names)
               if nm == "K0" or nm.startswith("K") or nm in ("l", "B", "S")]
    s_hi = (None if problem._i_S is None else
            int(math.floor(problem.sampling.s_cap(problem.sys.N) + 1e-9)))
    best = None
    for mode in (math.floor, round, math.ceil):
        zc = z.copy()
        for i in int_idx:
            iv = max(1, mode(float(np.exp(z[i]))))
            if s_hi is not None and v.names[i] == "S":
                iv = min(iv, s_hi)         # rounding must not breach pi<=1
            zc[i] = np.log(iv)
        K0f, Knf, Bf, _, Sf = _extract(problem, zc)
        Si = _round_S(problem, Sf)
        Kni = np.maximum(1, np.ceil(Knf - 1e-9)).astype(np.int64)
        Bi = max(1, int(round(Bf)))
        K0_lo = max(1, math.floor(K0f))
        if joint:
            K0i, cand_extra, ok = min_feasible_K0_joint(problem, Kni, Bi,
                                                        K0_lo=K0_lo, S=Si)
        else:
            K0i, ok = min_feasible_K0(problem, Kni, Bi, extra, K0_lo=K0_lo,
                                      S=Si)
            cand_extra = extra
        if not ok:
            continue
        ev = problem.evaluate(K0i, Kni, Bi, cand_extra, S=Si)
        if best is None or ev["E"] < best[5]:
            best = (K0i, Kni, Bi, cand_extra, Si, ev["E"])
    if joint:
        best = _joint_integer_polish(problem, z, best)
    if best is None:
        # fall back to the ceil point even if (slightly) infeasible
        K0f, Knf, Bf, _, Sf = _extract(problem, z)
        Si = _round_S(problem, Sf, mode=math.ceil)
        Kni = np.maximum(1, np.ceil(Knf)).astype(np.int64)
        Bi = max(1, math.ceil(Bf))
        K0i = max(1, math.ceil(K0f))
        ev = problem.evaluate(K0i, Kni, Bi, extra, S=Si)
        best = (K0i, Kni, Bi, extra, Si, ev["E"])
    return best
