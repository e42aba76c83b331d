"""Geometric-program solver: log-space primal barrier Newton method.

Standard-form GP:  min f0(x)  s.t.  f_i(x) <= 1,  x > 0,
with f_i posynomials.  In z = log x the problem is convex:
    min LSE_0(z)  s.t.  g_i(z) = LSE_i(z) <= 0.

Textbook log-barrier interior-point, pure NumPy float64.  All constraints are
evaluated *batched*: their (log c, A) rows are concatenated once and per-
constraint log-sum-exps / gradients / Hessian pieces come from segment
reductions — the Newton iteration is a handful of small matmuls.
Strict feasibility comes from a phase-I GP (min S s.t. f_i/S <= 1), itself a
GP with a trivially feasible start.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .posy import Posy

__all__ = ["GP", "solve_gp", "GPResult", "BatchedGPResult", "GP_BACKENDS",
           "register_gp_backend", "solve_gp_batch"]


@dataclasses.dataclass
class GP:
    objective: Posy
    constraints: List[Posy]  # each <= 1

    @property
    def n(self) -> int:
        return self.objective.n


@dataclasses.dataclass
class GPResult:
    z: np.ndarray          # log-space optimum
    x: np.ndarray          # exp(z)
    obj: float
    feasible: bool
    max_violation: float   # max_i log f_i (<= 0 when feasible)
    newton_iters: int


class _Batched:
    """Concatenated constraint system with segment reductions."""

    def __init__(self, gp: GP):
        self.n = gp.n
        self.obj_logc = np.log(gp.objective.c)
        self.obj_A = gp.objective.A
        if gp.constraints:
            self.logc = np.concatenate([np.log(c.c) for c in gp.constraints])
            self.A = np.concatenate([c.A for c in gp.constraints], axis=0)
            sizes = np.array([c.n_terms for c in gp.constraints])
            self.starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            self.seg = np.repeat(np.arange(len(sizes)), sizes)
            self.m = len(sizes)
        else:
            self.m = 0

    # -- constraint log-values g_i(z) ------------------------------------
    def g(self, z):
        t = self.logc + self.A @ z
        mx = np.maximum.reduceat(t, self.starts)
        s = np.add.reduceat(np.exp(t - mx[self.seg]), self.starts)
        return mx + np.log(s)

    def f0(self, z):
        t = self.obj_logc + self.obj_A @ z
        mx = t.max()
        return float(mx + np.log(np.exp(t - mx).sum()))

    def barrier(self, z, t_scale):
        """(phi, grad, hess) of t*f0 - sum log(-g_i); phi=inf off-domain."""
        # objective part
        t0 = self.obj_logc + self.obj_A @ z
        mx0 = t0.max()
        e0 = np.exp(t0 - mx0)
        s0 = e0.sum()
        w0 = e0 / s0
        f0 = mx0 + np.log(s0)
        q0 = self.obj_A.T @ w0
        H = t_scale * ((self.obj_A.T * w0) @ self.obj_A - np.outer(q0, q0))
        grad = t_scale * q0
        phi = t_scale * f0
        if self.m:
            t = self.logc + self.A @ z
            mx = np.maximum.reduceat(t, self.starts)
            e = np.exp(t - mx[self.seg])
            s = np.add.reduceat(e, self.starts)
            g = mx + np.log(s)
            if np.any(g >= 0.0):
                return np.inf, None, None
            w = e / s[self.seg]
            c = 1.0 / (-g)                        # (m,), > 0
            phi += float(-np.log(-g).sum())
            wc = w * c[self.seg]
            # q_i = A^T w_i  (per constraint), via segment sums
            Q = np.zeros((self.m, self.n))
            np.add.at(Q, self.seg, w[:, None] * self.A)
            grad = grad + Q.T @ c
            H = H + (self.A.T * wc) @ self.A + (Q.T * (c**2 - c)) @ Q
        return phi, grad, H

    def value(self, z, t_scale):
        t0 = self.obj_logc + self.obj_A @ z
        mx0 = t0.max()
        phi = t_scale * float(mx0 + np.log(np.exp(t0 - mx0).sum()))
        if self.m:
            g = self.g(z)
            if np.any(g >= 0.0):
                return np.inf
            phi += float(-np.log(-g).sum())
        return phi


def _newton(bat: _Batched, z: np.ndarray, t: float, tol: float = 1e-9,
            max_iter: int = 200):
    iters = 0
    eye = np.eye(bat.n)
    for _ in range(max_iter):
        phi, grad, hess = bat.barrier(z, t)
        assert np.isfinite(phi), "Newton started outside barrier domain"
        lam = 1e-12
        while True:
            try:
                Lc = np.linalg.cholesky(hess + lam * eye)
                break
            except np.linalg.LinAlgError:
                lam = max(lam * 10.0, 1e-10)
        step = -np.linalg.solve(Lc.T, np.linalg.solve(Lc, grad))
        dec = -grad @ step
        if dec / 2.0 <= tol:
            return z, iters
        alpha, beta, a = 0.25, 0.5, 1.0
        gs = grad @ step
        for _ in range(60):
            phin = bat.value(z + a * step, t)
            if np.isfinite(phin) and phin <= phi + alpha * a * gs:
                break
            a *= beta
        else:
            return z, iters  # stalled
        z = z + a * step
        iters += 1
    return z, iters


def _phase_one(gp: GP, z0: np.ndarray, target_margin: float = 1e-3):
    """Strictly feasible z via the auxiliary GP  min S, f_i/S <= 1."""
    n = gp.n
    aug_cons = [Posy(c.c, np.concatenate([c.A, -np.ones((c.n_terms, 1))],
                                         axis=1))
                for c in gp.constraints]
    A_obj = np.zeros((1, n + 1))
    A_obj[0, -1] = 1.0
    aug = GP(Posy(np.array([1.0]), A_obj), aug_cons)
    bat_orig = _Batched(gp)
    bat = _Batched(aug)
    s0 = float(bat_orig.g(z0).max()) + 1.0
    za = np.concatenate([z0, [s0]])
    t = 1.0
    total = 0
    for _ in range(40):
        za, it = _newton(bat, za, t)
        total += it
        if za[-1] < -target_margin \
                and float(bat_orig.g(za[:n]).max()) < -target_margin:
            return za[:n], True, total
        if len(aug_cons) / t < 1e-9:
            break
        t *= 20.0
    z = za[:n]
    return z, bool(bat_orig.g(z).max() < 0.0), total


def solve_gp(gp: GP, z0: Optional[np.ndarray] = None, tol_gap: float = 1e-8,
             t0: float = 1.0, mu: float = 20.0) -> GPResult:
    n = gp.n
    z = np.zeros(n) if z0 is None else np.asarray(z0, dtype=np.float64).copy()
    bat = _Batched(gp)
    total_iters = 0
    if bat.m and float(bat.g(z).max()) >= 0.0:
        z, ok, it = _phase_one(gp, z)
        total_iters += it
        if not ok:
            viol = float(bat.g(z).max())
            return GPResult(z, np.exp(z), gp.objective.value(z), False, viol,
                            total_iters)
    if not bat.m:
        z, it = _newton(bat, z, 1.0)
        return GPResult(z, np.exp(z), gp.objective.value(z), True, -np.inf, it)
    t = t0
    while True:
        z, it = _newton(bat, z, t)
        total_iters += it
        if bat.m / t < tol_gap:
            break
        t *= mu
    viol = float(bat.g(z).max())
    return GPResult(z, np.exp(z), gp.objective.value(z), viol <= 1e-7, viol,
                    total_iters)


# ---------------------------------------------------------------------------
# batched solving: pluggable backends (mirroring repro_torch.compress.backends)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BatchedGPResult:
    """Per-instance results of one batched solve (leading axis = batch)."""
    z: np.ndarray              # (B, n) log-space optima
    obj: np.ndarray            # (B,)
    feasible: np.ndarray       # (B,) bool
    max_violation: np.ndarray  # (B,)
    newton_iters: np.ndarray   # (B,) int


def _solve_batch_numpy(pack, device=None) -> BatchedGPResult:
    """Reference backend: the scalar interior point looped over the batch
    (on the host; ``device`` is not read).

    Operates on the unpadded per-instance GPs, so each active row is
    bit-identical to a standalone :func:`solve_gp` call — the parity anchor
    for every other backend.  Inactive rows return placeholders (z0
    passthrough, infeasible) that callers must not read.
    """
    rs = [solve_gp(gp, pack.z0[i]) if pack.active[i] else
          GPResult(pack.z0[i], np.exp(pack.z0[i]), np.nan, False, np.inf, 0)
          for i, gp in enumerate(pack.gps)]
    return BatchedGPResult(
        z=np.stack([r.z for r in rs]),
        obj=np.array([r.obj for r in rs]),
        feasible=np.array([r.feasible for r in rs], dtype=bool),
        max_violation=np.array([r.max_violation for r in rs]),
        newton_iters=np.array([r.newton_iters for r in rs], dtype=np.int64))


GP_BACKENDS = {"numpy": _solve_batch_numpy}

#: the JAX package's device backends -> the port's counterparts
JAX_BACKENDS = {"jnp": "torch", "jnp-fused": "torch-fused"}


def register_gp_backend(name: str, solve_batch) -> None:
    """Register ``solve_batch(pack: PackedBatch, device)``, which returns a
    :class:`BatchedGPResult`."""
    GP_BACKENDS[str(name)] = solve_batch


def refuse_jax_backend(backend: str) -> None:
    """``"jnp"``/``"jnp-fused"`` name the JAX package's engines: raise
    ``ValueError`` naming the port's counterparts."""
    if backend in JAX_BACKENDS:
        raise ValueError(
            f"solver backend {backend!r} is the JAX package's; the port's "
            f"device backends are 'torch' (batched GP solves) and "
            f"'torch-fused' (the whole GIA), counterpart "
            f"{JAX_BACKENDS[backend]!r}")


def solve_gp_batch(pack, backend: str = "numpy",
                   device="cuda") -> BatchedGPResult:
    """Solve every instance of a
    :class:`~repro_torch.opt.structure.PackedBatch`.

    ``backend="numpy"`` loops the reference scalar solver on the host;
    ``backend="torch"`` solves the whole batch at once on ``device`` with
    the batched float64 interior point (:mod:`repro_torch.opt.gp_batched`).
    (The GIA-level ``backend="torch-fused"`` never reaches this function —
    it runs the whole outer loop in :mod:`repro_torch.opt.gia_fused`.)
    """
    refuse_jax_backend(backend)
    if backend == "torch" and backend not in GP_BACKENDS:
        from . import gp_batched  # noqa: F401  (registers itself on import)
    try:
        fn = GP_BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown GP backend {backend!r}; registered: "
                         f"{sorted(GP_BACKENDS)}") from None
    return fn(pack, device)
