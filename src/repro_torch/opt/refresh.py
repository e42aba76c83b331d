"""Device-side CGP condensation: the GIA coefficient refresh as tensor updates.

The fused solver (:mod:`repro_torch.opt.gia_fused`) keeps the whole GIA on
the device, so the surrogate coefficients that the host loop rebuilds in
Python at every expansion point (``condense.amgm_monomial`` / Taylor bounds
→ ``problems.conv_block`` → re-pack) are refreshed there as tensor updates.
A :class:`RefreshPlan` is built **once per batch** from the problems'
skeletons — which coefficient slots of the packed ``(log c, A,
segment-id)`` tensors depend on the expansion point z, and how — and
:func:`make_refresh` returns the matching torch update over a leading row
axis, a handful of batched ops with zero host syncs.

The arithmetic mirrors the NumPy surrogate constructors operation for
operation (same products, same reciprocals, same max-shifted softmax weights
in the AM-GM condensation), as the JAX package's jnp mirror does, so the
refreshed coefficients agree with ``conv_block`` to ulp level in log-space
(``tests/test_torch_solver.py`` holds them over the (m, family) grid).

Plan layout per objective m (term counts are z-independent, so every slot is
static; only the m=E surrogate (32) flips between 2 and 1 live terms, which
the plan handles with one padded slot):

  C:  [ head/M | mid | tail/M ]                       M = AM-GM(sum_n K_n)
  J:  [ head/M | mid | tail/M ] [ gamma_cap ]
  D:  [ (head/M | mid | tail/M | b·C_max) / (C_max·a·K0) ]   a,b Taylor(K0)
  E:  [ num/M_den ] [ (32) 2-slot branch ] [ (33) ] [ x0_cap ]

Free-cohort sampling (``sampled=True``, repro_torch.sampling models with the
"S" variable) replaces the C/J/D layouts with the exact ratio form built by
``problems._conv_static`` — the whole constraint multiplied through by
sum_n eps_n K_n, the participation penalty's negative part in the
denominator:

  C:  [ fs_num / AM-GM(fs_den) ]
  J:  [ fs_num / AM-GM(fs_den) ] [ gamma_cap ]
  D:  [ (fs_num | b·fs_numB) / AM-GM(a·fs_denK | fs_denQ) ]  a,b Taylor(K0)

m=E is untouched: its num/den ratio absorbs the extra static terms and the
existing refresh is term-count-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .problems import Objective, ParamOptProblem
from .structure import PAD_LOGC, structure_signature

__all__ = ["RefreshPlan", "make_refresh", "make_project", "amgm", "mv",
           "arrays_to"]

#: the (32)/(33) interior margin of problems._conv_constraint, bit-identical
_DELTA = float(np.exp(-3e-3))


def _row(posys) -> Tuple[np.ndarray, np.ndarray]:
    """Stack 1-term posynomials into ((B,) coeffs, (B, n) exponent rows)."""
    return (np.stack([p.c[0] for p in posys]),
            np.stack([p.A[0] for p in posys]))


def _terms(posys) -> Tuple[np.ndarray, np.ndarray]:
    """Stack same-shape posynomials into ((B, K) coeffs, (B, K, n))."""
    return np.stack([p.c for p in posys]), np.stack([p.A for p in posys])


@dataclasses.dataclass
class RefreshPlan:
    """One structure signature's fused-solver inputs.

    Static layout (``caps``, ``seg``, objective kind) keys the fused step
    program; the per-instance tensors (objective, packed skeleton, and the
    m-specific surrogate coefficients in ``arrays``) are its runtime
    arguments.  Built once per batch — the GIA loop never re-packs.
    """

    m: Objective
    n: int                      # number of optimization variables
    m_cons: int                 # constraint count incl. conv block
    caps: Tuple[int, ...]       # per-conv-constraint term capacities
    seg: np.ndarray             # (T,) int32 constraint id per packed term
    i_x0: int                   # index of the X0 variable (m=E), else -1
    obj_logc: np.ndarray        # (B, K_obj)
    obj_A: np.ndarray           # (B, K_obj, n)
    skel_logc: np.ndarray       # (B, T_common) z-independent constraints
    skel_A: np.ndarray          # (B, T_common, n)
    arrays: Dict[str, np.ndarray]   # m-specific refresh coefficients
    sampled: bool = False       # free-cohort (ratio-form) C/J/D conv block

    @property
    def batch(self) -> int:
        return self.obj_logc.shape[0]

    @property
    def signature_key(self) -> tuple:
        """Hashable static layout — one fused step program per value."""
        return (self.m.value, self.n, self.m_cons, self.caps,
                self.seg.tobytes(), self.i_x0, self.sampled)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, problems: Sequence[ParamOptProblem]) -> "RefreshPlan":
        problems = list(problems)
        sig = structure_signature(problems[0])
        for p in problems[1:]:
            if structure_signature(p) != sig:
                raise ValueError(
                    f"refresh plan needs one structure signature, got both "
                    f"{sig} and {structure_signature(p)}")
        p0 = problems[0]
        m, v = p0.m, p0.vmap
        sts = [p._conv_static for p in problems]
        st0 = sts[0]

        objs = [p.skeleton[0] for p in problems]
        obj_c, obj_A = _terms(objs)
        skels = [p.packed_skeleton for p in problems]
        skel_logc = np.stack([s[0] for s in skels])
        skel_A = np.stack([s[1] for s in skels])
        common_sizes = [c.n_terms for c in p0.skeleton[1]]

        a: Dict[str, np.ndarray] = {}
        sampled = "fs_num" in st0
        if sampled:
            a["fsnum_c"], a["fsnum_A"] = _terms([st["fs_num"] for st in sts])
            if m is Objective.DIMINISHING:
                a["fsnumB_c"], a["fsnumB_A"] = _terms(
                    [st["fs_numB"] for st in sts])
                a["fsdenK_c"], a["fsdenK_A"] = _terms(
                    [st["fs_denK"] for st in sts])
                a["fsdenQ_c"], a["fsdenQ_A"] = _terms(
                    [st["fs_denQ"] for st in sts])
                a["rho"] = np.array([p.rho for p in problems],
                                    dtype=np.float64)
                a["K0_c"], a["K0_A"] = _row([p.vmap.K0 for p in problems])
                caps = (st0["fs_num"].n_terms + st0["fs_numB"].n_terms,)
            else:
                fsden_c, a["fsden_A"] = _terms([st["fs_den"] for st in sts])
                a["fsden_logc"] = np.log(fsden_c)
                if m is Objective.JOINT:
                    gcap_c, a["gcap_A"] = _terms(
                        [st["gamma_cap"] for st in sts])
                    a["gcap_logc"] = np.log(gcap_c)
                    caps = (st0["fs_num"].n_terms, 1)
                else:
                    caps = (st0["fs_num"].n_terms,)
            sizes = np.asarray(common_sizes + list(caps), dtype=np.int64)
            seg = np.repeat(np.arange(sizes.size, dtype=np.int32), sizes)
            return cls(m=m, n=v.n, m_cons=int(sizes.size), caps=caps,
                       seg=seg, i_x0=-1, obj_logc=np.log(obj_c), obj_A=obj_A,
                       skel_logc=skel_logc, skel_A=skel_A, arrays=a,
                       sampled=True)
        if m is Objective.EXPONENTIAL:
            a["num_c"], a["num_A"] = _terms([st["num"] for st in sts])
            den_c, a["den_A"] = _terms([st["den"] for st in sts])
            a["den_logc"] = np.log(den_c)
            a["lamX0K0_c"], a["lamX0K0_A"] = _row(
                [st["lam_X0K0"] for st in sts])
            a["lamX0K0_logc"] = np.log(a["lamX0K0_c"])
            a["lamK0_c"], a["lamK0_A"] = _row([st["lam_K0"] for st in sts])
            x0cap_c, a["x0cap_A"] = _terms([st["x0_cap"] for st in sts])
            a["x0cap_logc"] = np.log(x0cap_c)
            a["X0_c"], a["X0_A"] = _row([p.vmap.extra for p in problems])
            a["K0_c"], a["K0_A"] = _row([p.vmap.K0 for p in problems])
            a["K0_logc"] = np.log(a["K0_c"])
            a["log_rho"] = np.log(np.array([p.rho for p in problems],
                                           dtype=np.float64))
            caps = (st0["num"].n_terms, 2, 2, 1)
            i_x0 = v.names.index("extra")
        else:
            sumK_c, a["sumK_A"] = _terms([st["sumK"] for st in sts])
            a["sumK_logc"] = np.log(sumK_c)
            a["head_c"], a["head_A"] = _terms(
                [st["overM_head"] for st in sts])
            mid_c, a["mid_A"] = _terms([st["mid"] for st in sts])
            a["mid_c"], a["mid_logc"] = mid_c, np.log(mid_c)
            a["tail_c"], a["tail_A"] = _terms(
                [st["overM_tail"] for st in sts])
            base = (st0["overM_head"].n_terms + st0["mid"].n_terms
                    + st0["overM_tail"].n_terms)
            if m is Objective.JOINT:
                gcap_c, a["gcap_A"] = _terms([st["gamma_cap"] for st in sts])
                a["gcap_logc"] = np.log(gcap_c)
                caps = (base, 1)
            elif m is Objective.DIMINISHING:
                a["rho"] = np.array([p.rho for p in problems],
                                    dtype=np.float64)
                a["Cmax"] = np.array([p.C_max for p in problems],
                                     dtype=np.float64)
                a["K0_c"], a["K0_A"] = _row([p.vmap.K0 for p in problems])
                caps = (base + 1,)
            else:
                caps = (base,)
            i_x0 = -1

        sizes = np.asarray(common_sizes + list(caps), dtype=np.int64)
        seg = np.repeat(np.arange(sizes.size, dtype=np.int32), sizes)
        return cls(m=m, n=v.n, m_cons=int(sizes.size), caps=caps, seg=seg,
                   i_x0=i_x0, obj_logc=np.log(obj_c), obj_A=obj_A,
                   skel_logc=skel_logc, skel_A=skel_A, arrays=a)


# ---------------------------------------------------------------------------
# the torch refresh — mirrors condense.py / problems._conv_constraint
# exactly, over a leading row axis (the JAX package vmaps one row)
# ---------------------------------------------------------------------------
def mv(A, z):
    """Row-batched matrix-vector product ``A @ z`` over the last axis:
    ``(B, K, n) x (B, n) -> (B, K)`` (or ``(B, n) x (B, n) -> (B,)``), as a
    product and one sum over the short n axis, so each row's value does not
    depend on the batch size."""
    return (A * (z[:, None, :] if A.dim() == 3 else z)).sum(-1)


def amgm(logc, A, z):
    """Row-batched mirror of :func:`repro_torch.opt.condense.amgm_monomial`
    (same shifted softmax, same 0·log0 masking) on precomputed term logs:
    ``(B, K), (B, K, n), (B, n) -> (B,), (B, n)``."""
    t = logc + mv(A, z)
    mx = t.amax(-1, keepdim=True)
    e = torch.exp(t - mx)
    beta = e / e.sum(-1, keepdim=True)
    keep = beta > 0.0
    logc_m = torch.where(
        keep, beta * (logc - torch.log(torch.where(keep, beta, 1.0))),
        0.0).sum(-1)
    A_m = (beta[..., None] * A).sum(1)
    return logc_m, A_m


def arrays_to(arrays: Dict[str, np.ndarray], device) -> dict:
    """A plan's refresh arrays as float64 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.float64, device=device)
            for k, v in arrays.items()}


def make_refresh(m: Objective, n: int, caps: Tuple[int, ...],
                 sampled: bool = False):
    """The row-batched coefficient refresh ``(z, arrays) -> (logc, A)`` for
    one conv block, as torch ops over a leading row axis.

    Output shapes are ``(B, sum(caps))`` / ``(B, sum(caps), n)`` — the conv
    segment of the packed constraint tensors; unused slots carry
    :data:`~repro_torch.opt.structure.PAD_LOGC`.  ``sampled`` selects the
    free-cohort ratio-form C/J/D refresh (m=E needs no variant).
    """
    def col(x):                       # a per-row scalar as a (B, 1) column
        return x[:, None]

    if sampled and m in (Objective.CONSTANT, Objective.JOINT):

        def refresh(z, a):
            # mirror of ratio_to_posy(fs_num, fs_den, z): num coefficients
            # divided by the AM-GM-condensed denominator monomial
            logc_d, A_d = amgm(a["fsden_logc"], a["fsden_A"], z)
            logc = torch.log(a["fsnum_c"] * col(1.0 / torch.exp(logc_d)))
            A = a["fsnum_A"] - A_d[:, None, :]
            if m is Objective.JOINT:
                logc = torch.cat([logc, a["gcap_logc"]], 1)
                A = torch.cat([A, a["gcap_A"]], 1)
            return logc, A

        return refresh

    if sampled and m is Objective.DIMINISHING:

        def refresh(z, a):
            rho = a["rho"]
            k0 = torch.exp(mv(a["K0_A"], z)) * a["K0_c"]
            # same Taylor lower bound of phi(K0) as the pinned branch
            at = (torch.log((k0 + rho + 1.0) / (rho + 1.0))
                  + k0 / (k0 + rho + 1.0))
            bt = k0 ** 2 / (k0 + rho + 1.0)
            den_logc = torch.log(torch.cat(
                [a["fsdenK_c"] * col(at), a["fsdenQ_c"]], 1))
            den_A = torch.cat([a["fsdenK_A"], a["fsdenQ_A"]], 1)
            logc_d, A_d = amgm(den_logc, den_A, z)
            num_c = torch.cat([a["fsnum_c"], a["fsnumB_c"] * col(bt)], 1)
            num_A = torch.cat([a["fsnum_A"], a["fsnumB_A"]], 1)
            return (torch.log(num_c * col(1.0 / torch.exp(logc_d))),
                    num_A - A_d[:, None, :])

        return refresh

    if m in (Objective.CONSTANT, Objective.JOINT):

        def refresh(z, a):
            logc_m, A_m = amgm(a["sumK_logc"], a["sumK_A"], z)
            inv = col(1.0 / torch.exp(logc_m))
            A_m = A_m[:, None, :]
            logc = torch.cat([torch.log(a["head_c"] * inv), a["mid_logc"],
                              torch.log(a["tail_c"] * inv)], 1)
            A = torch.cat([a["head_A"] - A_m, a["mid_A"],
                           a["tail_A"] - A_m], 1)
            if m is Objective.JOINT:
                logc = torch.cat([logc, a["gcap_logc"]], 1)
                A = torch.cat([A, a["gcap_A"]], 1)
            return logc, A

        return refresh

    if m is Objective.DIMINISHING:

        def refresh(z, a):
            logc_m, A_m = amgm(a["sumK_logc"], a["sumK_A"], z)
            rho, cmax = a["rho"], a["Cmax"]
            k0 = torch.exp(mv(a["K0_A"], z)) * a["K0_c"]
            # Taylor lower bound of phi(K0) = K0 log((K0+rho+1)/(rho+1))
            at = (torch.log((k0 + rho + 1.0) / (rho + 1.0))
                  + k0 / (k0 + rho + 1.0))
            bt = k0 ** 2 / (k0 + rho + 1.0)
            inv = col(1.0 / torch.exp(logc_m))
            A_m = A_m[:, None, :]
            lhs_c = torch.cat([a["head_c"] * inv, a["mid_c"],
                               a["tail_c"] * inv, col(bt * cmax)], 1)
            lhs_A = torch.cat([a["head_A"] - A_m, a["mid_A"],
                               a["tail_A"] - A_m,
                               torch.zeros_like(a["K0_A"])[:, None, :]], 1)
            den_c = a["K0_c"] * (cmax * at)
            return (torch.log(lhs_c * col(1.0 / den_c)),
                    lhs_A - a["K0_A"][:, None, :])

        return refresh

    if m is Objective.EXPONENTIAL:

        def refresh(z, a):
            # (31): num / AM-GM(den)
            logc_md, A_md = amgm(a["den_logc"], a["den_A"], z)
            c1_logc = torch.log(a["num_c"] * col(1.0 / torch.exp(logc_md)))
            c1_A = a["num_A"] - A_md[:, None, :]
            x0 = torch.exp(mv(a["X0_A"], z)) * a["X0_c"]
            zero = torch.zeros_like(a["X0_A"])
            # (32): X0 log(1/X0) <= X0 K0 log(1/rho), Taylor at X0_prev;
            # a negative slope moves across the inequality (2-term branch
            # collapses to 1 live term + one padded slot)
            at = torch.log(1.0 / x0) - 1.0
            bt = x0
            pos_logc = torch.log(torch.stack([a["X0_c"] * at, bt], 1)
                                 * col(1.0 / a["lamX0K0_c"]) * _DELTA)
            pos_A = (torch.stack([a["X0_A"], zero], 1)
                     - a["lamX0K0_A"][:, None, :])
            d32_logc = torch.stack([a["lamX0K0_logc"],
                                    torch.log(a["X0_c"] * (-at))], 1)
            d32_A = torch.stack([a["lamX0K0_A"], a["X0_A"]], 1)
            logc_m32, A_m32 = amgm(d32_logc, d32_A, z)
            neg_logc = torch.stack(
                [torch.log(bt * (1.0 / torch.exp(logc_m32)) * _DELTA),
                 torch.full_like(bt, PAD_LOGC)], 1)
            neg_A = torch.stack([-A_m32, zero], 1)
            pos = col(at >= 0)
            c2_logc = torch.where(pos, pos_logc, neg_logc)
            c2_A = torch.where(pos[..., None], pos_A, neg_A)
            # (33): K0 log(1/rho) + aX X0 <= -bX, affine bound of log X0
            ax = 1.0 / x0
            rhs = -(torch.log(x0) - 1.0)
            c3_logc = torch.log(torch.stack([a["lamK0_c"], a["X0_c"] * ax], 1)
                                * col(1.0 / rhs) * _DELTA)
            c3_A = torch.stack([a["lamK0_A"], a["X0_A"]], 1)
            return (torch.cat([c1_logc, c2_logc, c3_logc,
                               a["x0cap_logc"]], 1),
                    torch.cat([c1_A, c2_A, c3_A, a["x0cap_A"]], 1))

        return refresh

    raise ValueError(m)


def make_project(m: Objective, i_x0: int):
    """Row-batched mirror of :meth:`ParamOptProblem.project_expansion` —
    re-imposes X0 = rho^{K0} exactly before every m=E refresh; identity
    otherwise."""
    if m is not Objective.EXPONENTIAL:
        return lambda z, a: z

    def project(z, a):
        k0 = torch.exp(a["K0_logc"] + mv(a["K0_A"], z))
        return torch.cat([z[:, :i_x0], (k0 * a["log_rho"])[:, None],
                          z[:, i_x0 + 1:]], 1)

    return project
