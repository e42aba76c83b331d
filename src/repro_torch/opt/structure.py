"""Padded fixed-shape GP systems: the data layout of the batched solver.

A :class:`ParamOptProblem`'s GP sequence has a fixed *structure* determined by
``(m, family varmap, N)``: the objective and the common constraints (22)-(24)
plus box bounds never change between GIA iterations, and the convergence-error
block always contains the same constraints — only its coefficients (and the
AM-GM-condensed exponent rows) are refreshed at each expansion point.

:class:`GPStructure` freezes that layout into flat ``(log c, A, segment-id)``
arrays padded to per-constraint term capacities, so a whole batch of problem
instances sharing one structure — e.g. every ``C_max`` on a Fig.-5 sweep line
— stacks into dense ``(B, T)`` / ``(B, T, n)`` tensors that one batched
solver call (see :mod:`repro_torch.opt.gp_batched`) handles at once.  Padding
terms carry ``log c = -1e30``: they contribute exactly ``0.0`` to every
log-sum-exp, gradient, and Hessian in float64, so padded and unpadded systems
solve identically.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .gp import GP
from .posy import Posy
from .problems import ParamOptProblem

__all__ = ["PAD_LOGC", "GPStructure", "PackedBatch", "structure_signature"]

#: log-coefficient of padding terms — exp(PAD_LOGC + A z) == 0.0 exactly
PAD_LOGC = -1e30


def structure_signature(problem: ParamOptProblem) -> tuple:
    """Hashable key identifying the fixed GP layout of a problem instance.

    Instances with equal signatures (same objective m, same variable map
    shape, same worker count, same algorithm-family key, same sampling
    model) produce GPs of identical constraint counts and can be stacked
    into one :class:`PackedBatch`; budgets, step-size parameters, and
    system constants only change coefficients.  The family key is part of
    the signature even though families never change the packed *shapes*
    (:mod:`repro_torch.families` hooks are coefficient-only) so sweep grouping
    and the fused-program trace counters stay per-family.  The sampling
    element works the same way for pinned-cohort models (coefficient-only
    inflation — shapes match the unsampled problem, but a full-
    participation plan must never key a sampled scenario's cache pool);
    free-``S`` models also grow the varmap, so they differ in shape too.
    Neutral sampling (full participation, ``uniform(S=N)``) reports
    ``("full",)`` and shares the default problems' pools.  The fault
    element (repro_torch.faults) follows the sampling pattern: coefficient-only
    (availability / worst-case margins never change packed shapes), but a
    faulted plan must never key an unfaulted scenario's cache pool;
    neutral fault models report ``("none",)`` and share the default pools.
    """
    v = problem.vmap
    return (problem.m, v.n, tuple(v.names), problem.sys.N,
            problem.family.key, problem.sampling.signature(problem.sys.N),
            problem.faults.signature(problem.sys.N))


@dataclasses.dataclass
class PackedBatch:
    """One batch of same-structure GP instances in solver-ready layout.

    ``active`` marks rows whose solution the caller will read this
    iteration; inactive rows (converged / stalled-out GIA instances) carry
    their last packed coefficients and backends skip the work — their
    result rows are placeholders.
    """

    n: int                     # number of variables
    m_cons: int                # number of constraints (shared)
    seg: np.ndarray            # (T,) int32 constraint id per term (shared)
    obj_logc: np.ndarray       # (B, K_obj)
    obj_A: np.ndarray          # (B, K_obj, n)
    con_logc: np.ndarray       # (B, T)
    con_A: np.ndarray          # (B, T, n)
    z0: np.ndarray             # (B, n) projected expansion points
    active: np.ndarray         # (B,) bool
    convs: List[List[Posy]]    # per-instance convergence blocks
    problems: List[ParamOptProblem]

    @property
    def batch(self) -> int:
        return self.obj_logc.shape[0]

    @functools.cached_property
    def gps(self) -> List[GP]:
        """The unpadded per-instance GPs — built only when a backend
        actually walks them (the reference NumPy path; the torch backend
        consumes the packed arrays directly)."""
        out = []
        for p, conv in zip(self.problems, self.convs):
            obj, common = p.skeleton
            out.append(GP(obj, list(common) + conv))
        return out


class GPStructure:
    """The fixed layout shared by a batch of same-signature problems.

    Term capacities for the convergence block grow monotonically if an
    expansion point ever needs more terms (the m=E Taylor branch flips
    between 1 and 2 terms); a growth changes the padded shapes and therefore
    is seen by the torch backend as new shapes, nothing else.
    """

    def __init__(self, template: ParamOptProblem):
        self.signature = structure_signature(template)
        self.n = template.vmap.n
        obj, common = template.skeleton
        self.obj_terms = obj.n_terms
        self.common_sizes: Tuple[int, ...] = tuple(c.n_terms for c in common)
        self.n_common = len(common)
        self.n_common_terms = int(sum(self.common_sizes))
        self.conv_caps: Optional[List[int]] = None
        self._last: dict = {}     # instance idx -> (zp, conv) of last refresh
        self._seg: Optional[np.ndarray] = None     # for the current caps
        self._obj: dict = {}      # instance idx -> (log c, A) of objective

    # ------------------------------------------------------------------
    def _segments(self) -> np.ndarray:
        if self._seg is None:
            sizes = list(self.common_sizes) + list(self.conv_caps)
            self._seg = np.repeat(np.arange(len(sizes), dtype=np.int32),
                                  np.asarray(sizes, dtype=np.int64))
        return self._seg

    def pack_batch(self, problems: Sequence[ParamOptProblem],
                   zs: Sequence[np.ndarray],
                   active: Optional[Sequence[bool]] = None) -> PackedBatch:
        """Refresh coefficients at each instance's expansion point and stack.

        Returns projected expansion points in ``z0`` — callers must carry
        those (not the raw inputs) so step sizes match the scalar GIA loop.
        Inactive instances are not refreshed: they keep their last packed
        coefficients (their current ``z`` may be a stalled phase-I point
        the surrogate constructors were never meant to expand at).
        """
        B = len(problems)
        if active is None:
            active = [True] * B
        builds = []
        for i, (p, z) in enumerate(zip(problems, zs)):
            if structure_signature(p) != self.signature:
                raise ValueError(
                    f"problem signature {structure_signature(p)} does not "
                    f"match batch structure {self.signature}")
            if active[i] or i not in self._last:
                zp = p.project_expansion(np.asarray(z, dtype=np.float64))
                self._last[i] = (zp, p.conv_block(zp))
            zp, conv = self._last[i]
            builds.append((p, zp, conv))

        sizes = [[c.n_terms for c in conv] for _, _, conv in builds]
        n_conv = len(sizes[0])
        caps = [max(s[j] for s in sizes) for j in range(n_conv)]
        if self.conv_caps is None:
            self.conv_caps = caps
        elif any(b > a for a, b in zip(self.conv_caps, caps)):
            self.conv_caps = [max(a, b)
                              for a, b in zip(self.conv_caps, caps)]
            self._seg = None             # padded layout grew: new segments

        n, ncomm = self.n, self.n_common_terms
        T = ncomm + int(sum(self.conv_caps))
        obj_logc = np.empty((B, self.obj_terms))
        obj_A = np.empty((B, self.obj_terms, n))
        con_logc = np.full((B, T), PAD_LOGC)
        con_A = np.zeros((B, T, n))
        z0 = np.empty((B, n))
        for i, (p, zp, conv) in enumerate(builds):
            if i not in self._obj:           # objective is z-independent
                obj = p.skeleton[0]
                self._obj[i] = (np.log(obj.c), obj.A)
            obj_logc[i], obj_A[i] = self._obj[i]
            s_logc, s_A = p.packed_skeleton
            con_logc[i, :ncomm] = s_logc
            con_A[i, :ncomm] = s_A
            off = ncomm
            for cap, c in zip(self.conv_caps, conv):
                k = c.n_terms
                con_logc[i, off:off + k] = np.log(c.c)
                con_A[i, off:off + k] = c.A
                off += cap
            z0[i] = zp
        return PackedBatch(n=n, m_cons=self.n_common + n_conv,
                           seg=self._segments(), obj_logc=obj_logc,
                           obj_A=obj_A, con_logc=con_logc, con_A=con_A,
                           z0=z0, active=np.asarray(active, dtype=bool),
                           convs=[conv for _, _, conv in builds],
                           problems=list(problems))
