"""Device-resident GIA: the whole outer loop as one captured step program.

``backend="torch-fused"`` of
:func:`repro_torch.opt.gia.solve_param_opt_batched`:
the per-expansion-point coefficient refresh (:mod:`repro_torch.opt.refresh`),
the phase-I/Newton log-barrier interior point and the per-row convergence /
stall masking are one step function over the batch's rows.  On the card,
``_CHUNK`` steps of it are captured once per (structure signature, padded
batch, max_iter) as a CUDA graph and replayed until no row is active: one
host read per chunk, none per GIA outer iteration — the counterpart of the
JAX package's one ``lax.while_loop`` per signature, whose data-dependent
trip count a graph cannot hold.  On the CPU the same step function runs
eagerly in the same chunks.

The step is a per-row *state machine*, not a nest of per-phase loops: every
step performs exactly one damped-Newton step for every row, and each row
independently advances its own schedule — phase-I stages, barrier t-ramp,
GIA expansion-point transitions (where the surrogate coefficients refresh
on the device) — under lockstep masks, so a batch pays the maximum over
rows of each row's *total* Newton steps.  A row that is no longer active is
frozen: every update is masked by ``active``, ``stage_end``, ``gia_tr`` or
``reenter``, so steps past the last active row's end (the rest of the last
chunk) change no bit.

Per-row semantics replicate the host loop in :mod:`repro_torch.opt.gia` and
the scalar solver schedule in :mod:`repro_torch.opt.gp`: same Newton
tolerance and per-stage cap, same Armijo backtracking on precomputed term
logs, same damping ramp, same phase-I margins and stage budget, same
barrier t-ramp, same infeasible-retry / 8-strike stall-out bookkeeping.
Objective history is journaled into a NaN-filled ``(B, max_iter)`` buffer
and unpacked on the host after the last chunk.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, namedtuple
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..obs import REGISTRY as _METRICS
from ..obs import trace as _otrace
from ..obs.metrics import GLOBAL_SWITCH as _OBS_ON
from .gp_batched import (_CHUNK, _MU, _NEWTON_MAX, _P1_MARGIN, _P1_STAGES,
                         _T0, _TOL_GAP, SegLayout, objective_lse, newton_step)
from .problems import Objective
from .refresh import (RefreshPlan, arrays_to, make_project, make_refresh,
                      mv)

__all__ = ["solve_gia_fused", "capture_count", "CAPTURE_COUNTS",
           "compile_cache_info", "compile_cache_clear"]
#: host-loop stall budget, verbatim (gia.solve_param_opt_batched)
_STALL_MAX = 8
#: emergency bound on total steps (a legitimate solve is ~1e3-1e4 Newton
#: steps; this only guards against a logic bug hanging the loop)
_IT_CAP = 1_000_000

#: step-program build counter per (static signature key, padded batch) —
#: on the card each count is one CUDA-graph capture; replays never touch it
CAPTURE_COUNTS: Dict[tuple, int] = {}

_CacheInfo = namedtuple("CacheInfo", ["hits", "misses", "maxsize",
                                      "currsize"])
#: programs kept, least recently used dropped first (each holds its graphs
#: and their memory pools on the card)
_CACHE_MAX = 64
_PROGRAMS: "OrderedDict[tuple, _Program]" = OrderedDict()
_PROGRAMS_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0}
#: one capture at a time in the process (captures run in thread-local
#: mode, so other threads' launches may go on meanwhile)
_CAPTURE_LOCK = threading.Lock()


def capture_count(plan_or_key) -> int:
    key = getattr(plan_or_key, "signature_key", plan_or_key)
    return sum(v for k, v in CAPTURE_COUNTS.items() if k[0] == key)


def compile_cache_info():
    """Hit/miss statistics of the process-level step-program cache.

    The cache is owned by the module, not by any solver or batch object:
    every ``Scenario.optimize``, sweep and batched solve in the process
    shares the same programs, keyed by (structure signature, max_iter,
    chunk, device), and each program keeps one captured graph per padded
    batch shape.
    """
    return _CacheInfo(_STATS["hits"], _STATS["misses"], _CACHE_MAX,
                      len(_PROGRAMS))


def compile_cache_clear():
    with _PROGRAMS_LOCK:
        _PROGRAMS.clear()
        _STATS.update(hits=0, misses=0)


class FusedState(NamedTuple):
    """Per-row state of the fused GIA (leading axis = rows)."""
    z_aug: object       # (B, n+1) Newton iterate and phase-I slack
    z_exp: object       # (B, n) current expansion point (projected)
    z_out: object       # (B, n) last GIA iterate
    c_logc: object      # (B, T_conv) refreshed conv-block coefficients
    c_A: object         # (B, T_conv, n)
    p1: object          # (B,) bool: in phase-I
    t: object           # (B,) barrier scale
    p1_stage: object    # (B,) int
    newton_it: object   # (B,) int: Newton steps in the current stage
    gia_it: object      # (B,) int: GIA iterations done
    stall: object       # (B,) int: consecutive infeasible GIA iterations
    conv: object        # (B,) bool: converged
    active: object      # (B,) bool
    hist: object        # (B, max_iter) objective per feasible iteration
    nh: object          # (B,) int: history length


@dataclasses.dataclass
class _Inputs:
    """A batch's static inputs on the program's device."""
    tol: object
    obj_logc: object
    obj_A: object
    skel_logc: object
    skel_A: object
    arrays: dict
    pad_logc: object        # the layout's phantom term (SegLayout)
    pad_A: object

    def copy_(self, other: "_Inputs") -> None:
        for f in ("tol", "obj_logc", "obj_A", "skel_logc", "skel_A"):
            getattr(self, f).copy_(getattr(other, f))
        for k, v in self.arrays.items():
            v.copy_(other.arrays[k])

    def terms(self, c_logc, c_A):
        """The packed constraint terms: skeleton, conv block, phantom."""
        return (torch.cat([self.skel_logc, c_logc, self.pad_logc], 1),
                torch.cat([self.skel_A, c_A, self.pad_A], 1))


class _Shape(NamedTuple):
    """One padded batch shape's captured graph, its static buffers and the
    stream it runs on."""
    inp: _Inputs
    state: FusedState
    graph: object
    stream: object


class _Program:
    """One structure signature's fused step program on one device."""

    def __init__(self, key: tuple, m: Objective, n: int, m_cons: int,
                 seg: np.ndarray, caps: Tuple[int, ...], i_x0: int,
                 max_iter: int, sampled: bool, chunk: int, device):
        self.key, self.n, self.max_iter, self.chunk = key, n, max_iter, chunk
        self.device = device
        self.lay = SegLayout(n, m_cons, seg, device)
        self.refresh = make_refresh(m, n, caps, sampled)
        self.project = make_project(m, i_x0)
        self.cols = torch.arange(max_iter, device=device)
        self.lock = threading.Lock()        # held for a whole solve
        self.shapes: Dict[int, _Shape] = {}

    # ------------------------------------------------------------------
    def g_max(self, t_terms):
        return self.lay.lse(t_terms).amax(-1)

    def init(self, z0, inp: _Inputs) -> FusedState:
        """The initial GIA entry, identical to every later re-entry."""
        f64 = torch.float64
        B = z0.shape[0]
        zp0 = self.project(z0, inp.arrays)
        cl0, cA0 = self.refresh(zp0, inp.arrays)
        logc, A = inp.terms(cl0, cA0)
        g0 = self.g_max(logc + mv(A, zp0))
        need_p1 = g0 >= 0.0
        z_aug0 = torch.cat([zp0, torch.where(need_p1, g0 + 1.0, 0.0)[:, None]],
                           1)

        def ints():
            return torch.zeros(B, dtype=torch.int64, device=z0.device)

        return FusedState(
            z_aug=z_aug0, z_exp=zp0, z_out=zp0.clone(), c_logc=cl0, c_A=cA0,
            p1=need_p1, t=torch.full((B,), _T0, dtype=f64, device=z0.device),
            p1_stage=ints(), newton_it=ints(), gia_it=ints(), stall=ints(),
            conv=torch.zeros(B, dtype=torch.bool, device=z0.device),
            active=torch.ones(B, dtype=torch.bool, device=z0.device),
            hist=torch.full((B, self.max_iter), np.nan, dtype=f64,
                            device=z0.device),
            nh=ints())

    def step(self, st: FusedState, inp: _Inputs) -> FusedState:
        """One damped-Newton step and every transition, for every row."""
        n, lay, a = self.n, self.lay, inp.arrays
        logc, A = inp.terms(st.c_logc, st.c_A)
        active = st.active
        p1f = st.p1.to(torch.float64)
        ns = newton_step(lay, st.z_aug, p1f, st.t, inp.obj_logc, inp.obj_A,
                         logc, A)
        progressed = active & ~ns.small & ns.ls_ok
        au = torch.where(progressed, ns.al, 0.0)
        z_aug = torch.where(progressed[:, None],
                            st.z_aug + ns.al[:, None] * ns.step, st.z_aug)
        newton_it = st.newton_it + progressed
        stage_end = active & (ns.small | ~ns.ls_ok
                              | (newton_it >= _NEWTON_MAX))

        # ---- stage transitions ----------------------------------------
        # post-step term logs by linear shift — no fresh matvecs
        z_main = z_aug[:, :n]
        gmax = self.g_max(ns.t_main + au[:, None] * ns.dt_main)
        f0m = objective_lse(ns.t0 + au[:, None] * ns.dt0)
        ok_margin = (z_aug[:, n] < -_P1_MARGIN) & (gmax < -_P1_MARGIN)
        gap = lay.m_f / st.t
        p1_finished = ok_margin | (gap < 1e-9) \
            | (st.p1_stage + 1 >= _P1_STAGES)
        p1_ok = ok_margin | (gmax < 0.0)
        solve_done = gap < _TOL_GAP

        p1_orig = st.p1
        ramp = stage_end & torch.where(p1_orig, ~p1_finished, ~solve_done)
        t = torch.where(ramp, st.t * _MU, st.t)
        p1_stage = st.p1_stage + (ramp & p1_orig)
        newton_it = torch.where(stage_end, 0, newton_it)
        p1_to_main = stage_end & p1_orig & p1_finished & p1_ok
        t = torch.where(p1_to_main, _T0, t)

        # ---- GIA expansion-point transition ---------------------------
        gia_tr = stage_end & torch.where(p1_orig, p1_finished & ~p1_ok,
                                         solve_done)
        # feasible only via a completed main solve; a phase-I failure is
        # the infeasible-retry path (min-slack point, stall strike)
        feas = gia_tr & ~p1_orig & (gmax <= 1e-7)
        p1 = p1_orig & ~p1_to_main & ~gia_tr
        zp_next = self.project(z_main, a)
        # projected-vs-projected step, as in the host loop: m=E holds X0 a
        # delta-margin off the manifold the projection re-imposes
        gstep = (zp_next - st.z_exp).abs().amax(-1)
        # a row at gia_it == max_iter is inactive (feas False) and matches
        # no column: nothing is written out of bounds
        hist = torch.where((self.cols == st.gia_it[:, None]) & feas[:, None],
                           torch.exp(f0m)[:, None], st.hist)
        nh = st.nh + feas
        stall = torch.where(gia_tr, torch.where(feas, 0, st.stall + 1),
                            st.stall)
        newly_conv = feas & (gstep < inp.tol)
        gia_next = st.gia_it + gia_tr
        conv = st.conv | newly_conv
        active = active & torch.where(
            gia_tr, ~newly_conv & (stall <= _STALL_MAX)
            & (gia_next < self.max_iter), True)
        z_out = torch.where(gia_tr[:, None], z_main, st.z_out)
        z_exp = torch.where((gia_tr & active)[:, None], zp_next, st.z_exp)

        # re-entry at the new expansion point: the device-side surrogate
        # refresh (AM-GM / Taylor condensation of repro_torch.opt.refresh),
        # phase-I iff the retry point is not strictly feasible
        cl_new, cA_new = self.refresh(z_exp, a)
        reenter = gia_tr & active
        c_logc = torch.where(reenter[:, None], cl_new, st.c_logc)
        c_A = torch.where(reenter[:, None, None], cA_new, st.c_A)
        logc, A = inp.terms(c_logc, c_A)
        g0 = self.g_max(logc + mv(A, z_exp))
        need_p1 = g0 >= 0.0
        p1 = torch.where(reenter, need_p1, p1)
        t = torch.where(reenter, _T0, t)
        p1_stage = torch.where(reenter, 0, p1_stage)
        z_aug = torch.where(
            reenter[:, None],
            torch.cat([z_exp, torch.where(need_p1, g0 + 1.0, 0.0)[:, None]],
                      1),
            z_aug)
        return FusedState(z_aug, z_exp, z_out, c_logc, c_A, p1, t, p1_stage,
                          newton_it, gia_next, stall, conv, active, hist, nh)

    # ------------------------------------------------------------------
    def _count_build(self, B: int) -> None:
        CAPTURE_COUNTS[(self.key, B)] = CAPTURE_COUNTS.get((self.key, B),
                                                           0) + 1
        if _OBS_ON.on:
            _METRICS.counter("gia.compile_events").inc()

    def _capture(self, inp: _Inputs, state: FusedState, stream) -> _Shape:
        """Capture ``chunk`` steps over static buffers on ``stream``; the
        first step at this shape runs eagerly there first (library handles
        and workspaces are made outside the capture).  A capture that
        fails raises: there is no eager fallback on the card.  The failed
        graph is dropped with its stream, and the caller's stream is made
        current again (``torch.cuda.graph`` skips that when ending an
        invalidated capture raises), so the next call captures afresh."""
        with torch.cuda.stream(stream):
            self.step(state, inp)           # warm-up, result discarded
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        caller = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            try:
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    st = state
                    for _ in range(self.chunk):
                        st = self.step(st, inp)
                    for dst, src in zip(state, st):
                        dst.copy_(src)
            except BaseException:
                torch.cuda.set_stream(caller)
                raise
        return _Shape(inp, state, graph, stream)

    def results(self, st: FusedState):
        """``(z, conv, hist, nh)`` on the host, in one read."""
        f64 = torch.float64
        out = torch.cat([st.z_out, st.conv[:, None].to(f64), st.hist,
                         st.nh[:, None].to(f64)], 1).cpu().numpy()
        n = self.n
        return (out[:, :n], out[:, n] != 0.0, out[:, n + 1:-1],
                out[:, -1].astype(np.int64))

    def inputs(self, tol: float, plan: RefreshPlan) -> _Inputs:
        def put(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                   device=self.device)

        return _Inputs(put(tol), put(plan.obj_logc), put(plan.obj_A),
                       put(plan.skel_logc), put(plan.skel_A),
                       arrays_to(plan.arrays, self.device),
                       *self.lay.phantom(plan.batch))

    @torch.inference_mode()
    def run(self, tol: float, z0: np.ndarray, plan: RefreshPlan):
        """Solve one (padded) batch; returns numpy ``(z, conv, hist, nh)``
        and the number of chunks run — the host reads once after each
        chunk and once for the results."""
        dev = self.device

        def put(x):
            return torch.as_tensor(x, dtype=torch.float64, device=dev)

        B = z0.shape[0]
        if dev.type == "cuda":
            shape = self.shapes.get(B)
            stream = shape.stream if shape else torch.cuda.Stream(device=dev)
            with torch.cuda.stream(stream):
                inp = self.inputs(tol, plan)
                state = self.init(put(z0), inp)
            if shape is None:
                # stored, and counted, only once the capture has ended well
                shape = self._capture(inp, state, stream)
                self.shapes[B] = shape
                self._count_build(B)
            else:
                with torch.cuda.stream(stream):
                    shape.inp.copy_(inp)
                    for dst, src in zip(shape.state, state):
                        dst.copy_(src)
            chunks = 0
            with torch.cuda.stream(shape.stream):
                while chunks * self.chunk < _IT_CAP:
                    shape.graph.replay()
                    chunks += 1
                    if not bool(shape.state.active.any()):
                        break
                out = self.results(shape.state)
            return out, chunks
        inp = self.inputs(tol, plan)
        st = self.init(put(z0), inp)
        chunks = 0
        while chunks * self.chunk < _IT_CAP:
            for _ in range(self.chunk):
                st = self.step(st, inp)
            chunks += 1
            if not bool(st.active.any()):
                break
        if B not in self.shapes:            # counted once its run ended well
            self.shapes[B] = None
            self._count_build(B)
        return self.results(st), chunks


def _program(plan: RefreshPlan, max_iter: int, chunk: int,
             device) -> _Program:
    key = (plan.signature_key, int(max_iter), int(chunk), str(device))
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is not None:
            _STATS["hits"] += 1
            _PROGRAMS.move_to_end(key)
            return prog
        _STATS["misses"] += 1
        prog = _PROGRAMS[key] = _Program(
            plan.signature_key, plan.m, plan.n, plan.m_cons, plan.seg,
            plan.caps, plan.i_x0, int(max_iter), plan.sampled, int(chunk),
            device)
        if len(_PROGRAMS) > _CACHE_MAX:
            _PROGRAMS.popitem(last=False)
        return prog


def solve_gia_fused(problems: Sequence, z0s: Sequence[np.ndarray],
                    tol: float, max_iter: int, pad_to: int = 0,
                    device="cuda"
                    ) -> List[Tuple[np.ndarray, List[float], bool]]:
    """Run the fused lockstep GIA on ``device``; returns per-instance
    ``(z, history, converged)`` for :func:`repro_torch.opt.gia._finalize`.

    ``pad_to > len(problems)`` pads the batch to a fixed row count by
    replicating row 0 (padding rows solve normally and are discarded), so
    every dispatch of a structure signature shares one captured shape — a
    serving loop whose micro-batches vary in size still pays exactly one
    capture per signature.  Padding rows cannot stretch the lockstep: the
    trip count is the max of per-row totals, and a duplicate of row 0
    finishes exactly when row 0 does.
    """
    dev = resolve_device(device)
    plan = RefreshPlan.build(problems)
    z0 = [np.asarray(z, dtype=np.float64) for z in z0s]
    for i, z in enumerate(z0):
        # on the host, before any program or device call: a wrong-shape
        # warm seed costs no capture and leaves no device state behind
        if z.shape != (plan.n,):
            raise ValueError(f"z0 of row {i} has shape {z.shape}; the "
                             f"signature has n={plan.n} variables")
    z0 = np.stack(z0)
    prog = _program(plan, max_iter, _CHUNK, dev)
    pad = int(pad_to) - len(problems)
    if pad > 0:
        def _pad(a):
            return np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
        z0 = _pad(z0)
        plan = dataclasses.replace(
            plan, obj_logc=_pad(plan.obj_logc), obj_A=_pad(plan.obj_A),
            skel_logc=_pad(plan.skel_logc), skel_A=_pad(plan.skel_A),
            arrays={k: _pad(v) for k, v in plan.arrays.items()})
    _t0 = time.perf_counter() if _OBS_ON.on else 0.0
    with prog.lock:
        (z, conv, hist, nh), chunks = prog.run(float(tol), z0, plan)
    if _OBS_ON.on:
        # stamped strictly after the final read — the span brackets the
        # work and the reads the solve already paid, it never adds one
        _otrace.add_span("gia.fused_dispatch", _t0, time.perf_counter(),
                         rows=len(problems), padded=int(z0.shape[0]),
                         chunks=chunks, sig=str(plan.signature_key)[:160])
    out = []
    for i in range(len(problems)):
        col = hist[i]
        history = [float(v) for v in col[~np.isnan(col)]]
        assert len(history) == int(nh[i])
        out.append((z[i], history, bool(conv[i])))
    return out
