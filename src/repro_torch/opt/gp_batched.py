"""Batched float64 interior point in torch: the ``"torch"`` GP backend.

The same log-barrier interior point as :mod:`repro_torch.opt.gp` — phase-I
feasibility GP, damped-Cholesky Newton with Armijo backtracking, geometric
barrier schedule — written over the padded ``(log c, A, segment-id)`` layout
of :class:`~repro_torch.opt.structure.PackedBatch` with a leading row axis
(the JAX package's ``gp_jax`` vmaps one row):

  * every row advances its own schedule under masks, one damped-Newton step
    per row per :func:`gp_step` — phase-I stages, the barrier t-ramp and
    the Newton loop are a per-row state machine, not nested loops, so a
    batch pays the maximum over rows of each row's total Newton steps;
  * the loops whose trip count depends on the data become fixed, masked
    work: the damping ramp factors ``H + lam I`` at all of its ``lam`` in
    one batched ``cholesky_ex`` and takes each row's first success, the
    Armijo search evaluates all of its step lengths at once on the term
    logs (no matvecs per backtrack) and takes each row's first accepted;
  * per-constraint log-sum-exps / gradients / Hessian pieces are dense
    reductions over a static gather layout (:class:`SegLayout`), never
    atomics, so a row's result does not depend on the order of a scatter
    or on the batch it sits in.

The phase-I slack enters analytically (:func:`barrier_aug`): in phase-I
every constraint term carries a ``-S`` and the objective is ``S``, so the
Newton system is ``(n+1)``-dimensional without ever materializing the
augmented ``(T, n+1)`` exponent matrix; in main mode the spare coordinate is
ridged and its step is exactly 0.  :mod:`repro_torch.opt.gia_fused` reuses
these pieces for the whole GIA.

Everything is float64 (every tensor is made with an explicit dtype; the
default dtype of the training path is untouched): the barrier schedule
reaches t ~ 1e10, far past float32's resolution.  Parity with the NumPy
reference is asserted test-side across the (m, family) grid.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from .gp import BatchedGPResult, register_gp_backend
from .refresh import mv

__all__ = ["SegLayout", "barrier_aug", "newton_step", "gp_step",
           "solve_batch_torch"]

# the NumPy reference's hyper-parameters, verbatim
_NEWTON_TOL = 1e-9
_NEWTON_MAX = 200
_LS_ALPHA, _LS_BETA, _LS_MAX = 0.25, 0.5, 60
_P1_MARGIN = 1e-3
_P1_STAGES = 40
_T0, _MU, _TOL_GAP = 1.0, 20.0, 1e-8
#: steps between two host reads of whether any row still runs (on the
#: card, the fused engine's captured chunk)
_CHUNK = 32
#: the process's first CUDA ``cholesky_ex`` loads PyTorch's linear-algebra
#: library, which two threads doing so at once refuse ("lazy wrapper should
#: be called at most once"; a parallel sweep's groups in a fresh process):
#: that first call is made under this lock
_LINALG_LOCK = threading.Lock()
_linalg_loaded = False


def _load_linalg(device) -> None:
    global _linalg_loaded
    if _linalg_loaded or device.type != "cuda":
        return
    with _LINALG_LOCK:
        if not _linalg_loaded:
            torch.linalg.cholesky_ex(torch.ones(1, 1, dtype=torch.float64,
                                                device=device))
            _linalg_loaded = True


def _damping_ramp():
    """The damping values the reference tries, in order: 1e-12, then
    ``max(lam * 10, 1e-10)`` until one is >= 1e8 (the JAX package's cap;
    NumPy's ramp has none but never gets there)."""
    lams = [1e-12]
    while lams[-1] < 1e8:
        lams.append(max(lams[-1] * 10.0, 1e-10))
    return lams


class SegLayout:
    """Static per-signature tensors of the batched solver on one device.

    Segment reductions use a dense gather layout instead of a scatter: the
    one-term segments (every monomial constraint) are read by index, the
    multi-term segments through a ``(m2, K)`` index padded with the index
    of one phantom term appended after the T real ones (``log c = -inf``,
    a zero exponent row: ``-inf`` for the max, exactly ``0.0`` in every
    sum, see :meth:`with_phantom`).  Per-constraint vectors are kept in
    that grouped order — one-term segments first — and only their
    reductions over all constraints (max, sum, all) ever read them whole.
    """

    def __init__(self, n: int, m_cons: int, seg: np.ndarray, device):
        seg = np.asarray(seg, dtype=np.int64)
        T = seg.size
        sizes = np.bincount(seg, minlength=m_cons)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        ones = np.flatnonzero(sizes == 1)
        multi = np.flatnonzero(sizes > 1)
        kmax = int(sizes[multi].max()) if multi.size else 1
        midx = np.full((multi.size, kmax), T, dtype=np.int64)
        for r, j in enumerate(multi):
            midx[r, :sizes[j]] = np.arange(starts[j], starts[j] + sizes[j])
        order = np.concatenate([ones, multi])
        pos = np.empty(m_cons, dtype=np.int64)
        pos[order] = np.arange(m_cons)
        self.n, self.m = n, int(m_cons)
        self.device = torch.device(device)

        def put(a, dtype=torch.int64):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.single = put(starts[ones])           # (m1,) term of each
        self.multi = put(midx.reshape(-1))        # (m2 * kmax,) terms
        self.multi_shape = midx.shape
        # term -> its constraint (the phantom's: any, its e is exactly 0)
        self.expand_idx = put(np.append(pos[seg], 0))
        f64 = torch.float64
        self.m_f = put(float(m_cons), f64)       # m as a tensor: m / t
        self.eye = torch.eye(n + 1, dtype=f64, device=self.device)
        self.lams = put(_damping_ramp(), f64)
        self.alphas = put(_LS_BETA ** np.arange(_LS_MAX), f64)

    def phantom(self, B: int):
        """The phantom term of ``B`` rows: ``((B, 1) log c, (B, 1, n) A)``."""
        return (torch.full((B, 1), -np.inf, dtype=torch.float64,
                           device=self.device),
                torch.zeros((B, 1, self.n), dtype=torch.float64,
                            device=self.device))

    def with_phantom(self, logc, A):
        """Packed ``(B, T)`` / ``(B, T, n)`` terms with the phantom term
        appended — the layout every reduction below reads."""
        pl, pA = self.phantom(logc.shape[0])
        return torch.cat([logc, pl], 1), torch.cat([A, pA], 1)

    # -- segment reductions over the last (term) axis, phantom included --
    def _split(self, x, dim: int):
        """``x``'s one-term segments and its multi-term segments padded to
        ``(m2, kmax)``, gathered along ``dim``."""
        multi = x.index_select(dim, self.multi)
        return (x.index_select(dim, self.single),
                multi.unflatten(dim, self.multi_shape))

    def seg_max(self, t):
        one, multi = self._split(t, -1)
        return torch.cat([one, multi.amax(-1)], -1)

    def seg_sum(self, x):
        one, multi = self._split(x, -1)
        return torch.cat([one, multi.sum(-1)], -1)

    def seg_sum_rows(self, x):
        """Per-constraint sums of ``(B, T+1, k)`` rows -> ``(B, m, k)``."""
        one, multi = self._split(x, 1)
        return torch.cat([one, multi.sum(2)], 1)

    def expand(self, s):
        return s.index_select(-1, self.expand_idx)

    def lse(self, t):
        """Per-constraint log-sum-exp of term logs ``(..., T+1) -> (..., m)``
        (the last term the phantom)."""
        mx = self.seg_max(t)
        return mx + torch.log(self.seg_sum(torch.exp(t - self.expand(mx))))


def objective_lse(t0):
    """Objective log-sum-exp over the last axis."""
    mx0 = t0.amax(-1)
    return mx0 + torch.log(torch.exp(t0 - mx0[..., None]).sum(-1))


def _gram(X, w):
    """``X^T diag(w) X`` per row: ``(B, K, k), (B, K) -> (B, k, k)``."""
    return torch.matmul(X.transpose(1, 2) * w[:, None, :], X)


def barrier_aug(lay: SegLayout, z, s, p1f, tscale, obj_logc, obj_A, logc,
                A):
    """(phi, grad, hess, t_main, t0) of each row's current barrier over the
    (n+1) variables (z, S) — the phase-I slack enters *analytically*.

    In phase-I (``p1f = 1``) every constraint term carries a ``-S`` and the
    objective is S itself; because the per-constraint softmax weights sum
    to 1, the S-column of every per-constraint gradient is exactly -1 and
    all S-blocks of the Hessian reduce to weight sums.  In main mode
    (``p1f = 0``) the spare coordinate is ridged so the Newton system stays
    definite; its step component is exactly 0.  ``phi`` is ``inf`` off the
    barrier's domain.
    """
    t0 = obj_logc + mv(obj_A, z)
    mx0 = t0.amax(-1)
    e0 = torch.exp(t0 - mx0[:, None])
    s0 = e0.sum(-1)
    w0 = e0 / s0[:, None]
    q0 = (obj_A * w0[..., None]).sum(1)
    H0 = _gram(obj_A, w0) - q0[:, :, None] * q0[:, None, :]
    f0 = p1f * s + (1.0 - p1f) * (mx0 + torch.log(s0))
    t_main = logc + mv(A, z)
    t = t_main - (s * p1f)[:, None]
    mx = lay.seg_max(t)
    e = torch.exp(t - lay.expand(mx))
    ssum = lay.seg_sum(e)
    g = mx + torch.log(ssum)
    negg = torch.where(g < 0.0, -g, 1.0)
    phi = tscale * f0 - torch.log(negg).sum(-1)
    w = e / lay.expand(ssum)
    cinv = 1.0 / negg
    Q = lay.seg_sum_rows(w[..., None] * A)            # (B, m, n)
    wc = w * lay.expand(cinv)
    mvec = cinv ** 2 - cinv
    q1 = 1.0 - p1f
    grad_n = q1[:, None] * (tscale[:, None] * q0) \
        + (Q * cinv[..., None]).sum(1)
    grad_s = p1f * (tscale - cinv.sum(-1))
    Awc = (A * wc[..., None]).sum(1)
    Qm = (Q * mvec[..., None]).sum(1)
    H_nn = q1[:, None, None] * (tscale[:, None, None] * H0) \
        + _gram(A, wc) + _gram(Q, mvec)
    H_ns = p1f[:, None] * (-Awc - Qm)
    H_ss = p1f * (wc.sum(-1) + mvec.sum(-1)) + q1
    H = torch.cat([torch.cat([H_nn, H_ns[:, :, None]], 2),
                   torch.cat([H_ns[:, None, :], H_ss[:, None, None]], 2)], 1)
    grad = torch.cat([grad_n, grad_s[:, None]], 1)
    phi = torch.where((g < 0.0).all(-1), phi, np.inf)
    return phi, grad, H, t_main, t0


def damped_cholesky(lay: SegLayout, H):
    """Each row's Cholesky factor of ``H + lam I`` at the first ``lam`` of
    the damping ramp that factors; NaN where none does (as the JAX
    package's ramp leaves it)."""
    B, k, _ = H.shape
    lam = lay.lams
    Hl = H[:, None] + lam[None, :, None, None] * lay.eye
    _load_linalg(H.device)
    L, info = torch.linalg.cholesky_ex(Hl.reshape(-1, k, k))
    L = L.reshape(B, lam.shape[0], k, k)
    # a failed factorization is info != 0; test NaN too, as the reference
    # tests its factor (a NaN pivot need not set info)
    ok = (info.reshape(B, -1) == 0) & ~torch.isnan(L).any((-2, -1))
    first = ok.to(torch.int8).argmax(1)
    L = torch.take_along_dim(L, first[:, None, None, None], 1)[:, 0]
    return torch.where(ok.any(1)[:, None, None], L, np.nan)


def cho_solve(L, b):
    """``(L L^T)^{-1} b`` per row by two triangular solves."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                         upper=True)[..., 0]


class NewtonStep(NamedTuple):
    """One damped-Newton step for every row, before any masking."""
    step: object       # (B, n+1) direction
    al: object         # (B,) accepted step length (1 where ``small``)
    ls_ok: object      # (B,) the line search accepted a length
    small: object      # (B,) Newton decrement under tolerance
    t_main: object     # (B, T) constraint term logs at z
    dt_main: object    # (B, T) their change per unit step
    t0: object         # (B, K_obj) objective term logs at z
    dt0: object        # (B, K_obj)


def newton_step(lay: SegLayout, z_aug, p1f, tscale, obj_logc, obj_A, logc,
                A) -> NewtonStep:
    """Barrier, damped Newton direction and Armijo search for every row.

    The search evaluates all ``_LS_MAX`` step lengths ``beta^k`` at once on
    the term logs (moving along a fixed direction only shifts them
    linearly) and takes each row's first accepted length — the length the
    reference's backtracking loop stops at.
    """
    n = lay.n
    z, s = z_aug[:, :n], z_aug[:, n]
    phi, grad, H, t_main, t0 = barrier_aug(lay, z, s, p1f, tscale, obj_logc,
                                           obj_A, logc, A)
    step = -cho_solve(damped_cholesky(lay, H), grad)
    gs = (grad * step).sum(-1)
    small = -gs / 2.0 <= _NEWTON_TOL
    dz, ds = step[:, :n], step[:, n]
    dt_main = mv(A, dz)
    dt0 = mv(obj_A, dz)
    t_eff = t_main - (s * p1f)[:, None]
    dt_eff = dt_main - (ds * p1f)[:, None]
    al = lay.alphas                                    # (L,)
    t0a = t0[:, None, :] + al[None, :, None] * dt0[:, None, :]
    ga = lay.lse(t_eff[:, None, :] + al[None, :, None] * dt_eff[:, None, :])
    p1c = p1f[:, None]
    phin = tscale[:, None] * (p1c * (s[:, None] + al * ds[:, None])
                              + (1.0 - p1c) * objective_lse(t0a)) \
        - torch.log(torch.where(ga < 0.0, -ga, 1.0)).sum(-1)
    phin = torch.where((ga < 0.0).all(-1), phin, np.inf)
    ok = torch.isfinite(phin) \
        & (phin <= phi[:, None] + (_LS_ALPHA * al) * gs[:, None])
    found = ok.any(1)
    first = ok.to(torch.int8).argmax(1)
    al_row = torch.where(found, al[first], _LS_BETA ** _LS_MAX)
    return NewtonStep(step=step, al=torch.where(small, 1.0, al_row),
                      ls_ok=small | found, small=small, t_main=t_main,
                      dt_main=dt_main, t0=t0, dt0=dt0)


class GPState(NamedTuple):
    """Per-row state of the batched interior point."""
    z_aug: object       # (B, n+1) iterate and phase-I slack
    p1: object          # (B,) bool: in phase-I
    t: object           # (B,) barrier scale
    p1_stage: object    # (B,) int: phase-I stage index
    newton_it: object   # (B,) int: Newton steps in the current stage
    iters: object       # (B,) int: total Newton steps
    done: object        # (B,) bool
    p1_failed: object   # (B,) bool


def gp_step(lay: SegLayout, st: GPState, obj_logc, obj_A, logc,
            A) -> GPState:
    """One damped-Newton step and the stage transitions for every row;
    a finished row is frozen (every update is masked by ``~done``)."""
    n = lay.n
    active = ~st.done
    p1f = st.p1.to(torch.float64)
    ns = newton_step(lay, st.z_aug, p1f, st.t, obj_logc, obj_A, logc, A)
    progressed = active & ~ns.small & ns.ls_ok
    au = torch.where(progressed, ns.al, 0.0)
    z_aug = torch.where(progressed[:, None],
                        st.z_aug + ns.al[:, None] * ns.step, st.z_aug)
    newton_it = st.newton_it + progressed
    stage_end = active & (ns.small | ~ns.ls_ok | (newton_it >= _NEWTON_MAX))
    # post-step constraint values by linear shift — no fresh matvecs
    gmax = lay.lse(ns.t_main + au[:, None] * ns.dt_main).amax(-1)
    ok_margin = (z_aug[:, n] < -_P1_MARGIN) & (gmax < -_P1_MARGIN)
    gap = lay.m_f / st.t
    p1_finished = ok_margin | (gap < 1e-9) | (st.p1_stage + 1 >= _P1_STAGES)
    p1_ok = ok_margin | (gmax < 0.0)
    solve_done = gap < _TOL_GAP
    ramp = stage_end & torch.where(st.p1, ~p1_finished, ~solve_done)
    t = torch.where(ramp, st.t * _MU, st.t)
    to_main = stage_end & st.p1 & p1_finished & p1_ok
    failed = stage_end & st.p1 & p1_finished & ~p1_ok
    return GPState(
        z_aug=z_aug, p1=st.p1 & ~to_main & ~failed,
        t=torch.where(to_main, _T0, t),
        p1_stage=st.p1_stage + (ramp & st.p1),
        newton_it=torch.where(stage_end, 0, newton_it),
        iters=st.iters + progressed,
        done=st.done | failed | (stage_end & ~st.p1 & solve_done),
        p1_failed=st.p1_failed | failed)


@torch.inference_mode()
def solve_batch_torch(pack, device="cuda") -> BatchedGPResult:
    """Solve a :class:`~repro_torch.opt.structure.PackedBatch` on ``device``
    in lockstep; rows step eagerly, and every ``_CHUNK`` steps one host
    read asks whether any row is still running.  Inactive rows do no work
    (their result rows are placeholders the caller never reads)."""
    from .. import resolve_device

    dev = resolve_device(device)
    f64 = torch.float64
    lay = SegLayout(pack.n, pack.m_cons, pack.seg, dev)

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=f64, device=dev)

    obj_logc, obj_A = put(pack.obj_logc), put(pack.obj_A)
    logc, A = lay.with_phantom(put(pack.con_logc), put(pack.con_A))
    z0 = put(pack.z0)
    active = torch.as_tensor(np.asarray(pack.active, dtype=bool), device=dev)
    g0max = torch.where(active, lay.lse(logc + mv(A, z0)).amax(-1), -1.0)
    need_p1 = g0max >= 0.0
    B = z0.shape[0]
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    st = GPState(
        z_aug=torch.cat([z0, torch.where(need_p1, g0max + 1.0, 0.0)[:, None]],
                        1),
        p1=need_p1 & active, t=torch.full((B,), _T0, dtype=f64, device=dev),
        p1_stage=zeros, newton_it=zeros, iters=zeros, done=~active,
        p1_failed=torch.zeros(B, dtype=torch.bool, device=dev))
    while not bool(st.done.all()):        # each stage and phase-I bounded
        for _ in range(_CHUNK):
            st = gp_step(lay, st, obj_logc, obj_A, logc, A)
    z = st.z_aug[:, :pack.n]
    viol = lay.lse(logc + mv(A, z)).amax(-1)
    feasible = ~st.p1_failed & active & (viol <= 1e-7)
    obj = torch.exp(objective_lse(obj_logc + mv(obj_A, z)))
    return BatchedGPResult(
        z=z.cpu().numpy(), obj=obj.cpu().numpy(),
        feasible=feasible.cpu().numpy(), max_violation=viol.cpu().numpy(),
        newton_iters=st.iters.cpu().numpy().astype(np.int64))


register_gp_backend("torch", solve_batch_torch)
