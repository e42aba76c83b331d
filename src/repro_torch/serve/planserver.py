"""PlanServer: multi-tenant plan serving over the fused GIA engine.

The optimizer as a service: every device cohort (its own
:class:`~repro_torch.api.Scenario` — system, family, budgets) asks for its
own operating point, concurrently.  The fused solver already turns
same-signature batches into one captured step program on the card; this
module exploits that for an *open-loop stream* of heterogeneous requests:

  * **signature micro-batching** — ``submit()`` enqueues the request under
    its optimizer structure signature ``(m, family varmap, N)``; a
    dispatcher thread groups same-signature requests into micro-batches
    (admission ``window_s`` / ``max_batch`` knobs, modeled on the slot-based
    continuous batching in :mod:`repro_torch.serve.engine`) and dispatches
    each batch to ``backend="torch-fused"`` on ``device`` — padded to a
    fixed ``max_batch`` row count, so the whole trace pays **one CUDA-graph
    capture per distinct signature** (process-level cache of step programs
    in :mod:`repro_torch.opt.gia_fused`, asserted via its ``capture_count``
    hook);

  * **warm-start plan cache** — solved scenarios are cached under a
    quantized *fingerprint* of the problem's coefficient tensors.  An exact
    fingerprint match returns the frozen Plan without solving; a near match
    (same signature, relative distance ≤ ``warm_radius``) seeds the new
    row's GIA at the cached solution's expansion point, so warm rows
    re-converge in 1-3 GIA iterations instead of cold phase-I — warm and
    cold rows mix freely inside one micro-batch (per-row ``z0s`` in
    :func:`repro_torch.opt.gia.solve_param_opt_batched`).

Requests return :class:`PlanHandle`\\ s; ``handle.result()`` blocks until
the frozen :class:`~repro_torch.api.plan.Plan` is ready.
``Scenario.optimize(server=...)`` routes through a server transparently.

Failure isolation: a *poison* request (corrupt warm seed, pathological
coefficients) that makes the fused solver raise does not take its
micro-batch peers down — the dispatcher bisects the failing batch so every
healthy row re-converges, quarantines the poison row for solo retries with
capped exponential backoff, and only then errors its handle
(``stats()["bisections"/"quarantined"/"poisoned"]``).  A wrong-shape warm
seed fails on the host before any device call, so bisecting it costs no
capture.  Errors of the device itself do not reach the dispatcher: a
server built for the card on a host without one raises in its constructor.
Queued requests can be withdrawn with ``PlanHandle.cancel()``.

    with PlanServer(max_batch=16, window_s=0.02) as srv:   # on the card
        handles = [srv.submit(s) for s in scenarios]       # open-loop stream
        plans = [h.result() for h in handles]
        srv.stats()                                        # hit-rate, captures
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import resolve_device
from ..obs import trace as _otrace
from ..obs.metrics import GLOBAL_SWITCH as _OBS_ON
from ..obs.metrics import MetricsRegistry
from ..opt.gia import GIAResult, solve_param_opt_batched
from ..opt.gp import refuse_jax_backend
from ..opt.problems import Objective
from ..opt.refresh import RefreshPlan
from ..opt.structure import structure_signature

__all__ = ["PlanServer", "PlanHandle", "PlanCache", "fingerprint",
           "fingerprint_distance"]

#: the solver backends a server dispatches to
_BACKENDS = ("numpy", "torch", "torch-fused")


# ---------------------------------------------------------------------------
# scenario fingerprints
# ---------------------------------------------------------------------------
def fingerprint(problem) -> np.ndarray:
    """The problem instance as a flat coefficient vector.

    Concatenates the objective / packed-skeleton log-coefficients and the
    refresh plan's per-instance coefficient arrays (exponent rows are
    signature-determined, so they are skipped): two problems of one
    signature agree on this vector iff they are numerically the same
    instance — budgets, step-size parameters, Theorem-1 constants, and
    every cost-model coefficient all live in these tensors, so nothing a
    Scenario can vary escapes the fingerprint.
    """
    plan = RefreshPlan.build([problem])
    parts = [plan.obj_logc[0].ravel(), plan.skel_logc[0].ravel()]
    for k in sorted(plan.arrays):
        if k.endswith("_A"):
            continue
        parts.append(np.asarray(plan.arrays[k][0], np.float64).ravel())
    return np.concatenate(parts)


def fingerprint_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Scale-free nearness: max relative coordinate deviation."""
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def _quantize(vec: np.ndarray) -> bytes:
    # float32 keeps ~7 significant digits per coordinate — repeats of the
    # same Scenario collide exactly, genuinely different budgets never do
    return vec.astype(np.float32).tobytes()


# ---------------------------------------------------------------------------
# warm-start plan cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _CacheEntry:
    vec: np.ndarray
    result: GIAResult          # converged GIA result (z = expansion point)


class PlanCache:
    """LRU of converged solves keyed by (signature, quantized fingerprint).

    Two lookups: :meth:`get` (exact quantized match — serve the cached
    solution without solving) and :meth:`nearest` (closest cached neighbor
    of one signature — its continuous solution seeds a warm GIA row).
    Only *converged* results are cached: a stalled/infeasible point is not
    an expansion point anyone should warm-start from.
    """

    def __init__(self, maxsize: int = 4096):
        self.maxsize = int(maxsize)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, _CacheEntry]" = \
            collections.OrderedDict()          # (sig, fp) -> entry
        self._by_sig: Dict[tuple, Dict[bytes, _CacheEntry]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, sig: tuple, fp: bytes) -> Optional[_CacheEntry]:
        with self._lock:
            e = self._entries.get((sig, fp))
            if e is not None:
                self._entries.move_to_end((sig, fp))
            return e

    def nearest(self, sig: tuple, vec: np.ndarray
                ) -> Tuple[Optional[_CacheEntry], float]:
        with self._lock:
            pool = self._by_sig.get(sig)
            if not pool:
                return None, float("inf")
            best, best_d = None, float("inf")
            for e in pool.values():
                d = fingerprint_distance(vec, e.vec)
                if d < best_d:
                    best, best_d = e, d
            return best, best_d

    def put(self, sig: tuple, fp: bytes, entry: _CacheEntry):
        with self._lock:
            key = (sig, fp)
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._by_sig.setdefault(sig, {})[fp] = entry
            while len(self._entries) > self.maxsize:
                (osig, ofp), _ = self._entries.popitem(last=False)
                self._by_sig[osig].pop(ofp, None)


# ---------------------------------------------------------------------------
# request handle
# ---------------------------------------------------------------------------
class PlanHandle:
    """One submitted ``Scenario.optimize`` request.

    ``source`` records how it was served: ``"hit"`` (exact fingerprint —
    cached solution, no solve), ``"warm"`` (solved, seeded from the nearest
    cached neighbor), or ``"cold"`` (solved from ``z_init``).  After
    resolution ``converged`` mirrors the GIA verdict (exact hits are
    converged by construction — only converged results are cached).
    """

    def __init__(self, scenario, m, problem, sig, vec, fp):
        self.scenario = scenario
        self.m = m
        self.problem = problem
        self.sig = sig
        self.vec = vec
        self.fp = fp
        self.plan = None
        self.error: Optional[str] = None
        self.source: Optional[str] = None
        self.warm_dist: Optional[float] = None
        self.batch_size: Optional[int] = None
        self.converged: Optional[bool] = None
        self.cancelled = False
        self.t_submit = time.perf_counter()
        self.t_taken: Optional[float] = None   # popped into a micro-batch
        self.t_done: Optional[float] = None
        self.z0: Optional[np.ndarray] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("plan request still pending")
        if self.error is not None:
            raise RuntimeError(self.error)
        return self.plan

    def cancel(self) -> bool:
        """Withdraw a still-pending request.

        Returns True if the request was cancelled before solving began —
        the dispatcher then drops it while popping its batch and never
        spends solver time on it.  Returns False if the handle is already
        resolved (best-effort: a row that was mid-solve keeps its plan).
        A cancelled handle's ``result()`` raises ``RuntimeError``.
        """
        if self._event.is_set():
            return False
        self.cancelled = True
        self.error = "cancelled"
        self._resolve()
        return True

    def _resolve(self):
        self.t_done = time.perf_counter()
        self._event.set()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
class PlanServer:
    """Multi-tenant plan serving: signature micro-batching + warm-start
    cache over the fused GIA backend on ``device``.

    Knobs: ``max_batch`` (batch capacity *and* the fixed padded device
    shape — every dispatch of a signature replays one captured program),
    ``window_s`` (admission window: a batch launches when full or when its
    oldest request has waited this long), ``warm_radius`` (max relative
    fingerprint distance for warm-start seeding), ``cache_size`` (LRU
    entries), ``quarantine_retries``/``retry_base_s``/``retry_cap_s``
    (solo-retry budget and backoff for quarantined poison rows).
    ``tol``/``max_iter``/``device`` are server-wide so every micro-batch of
    a signature shares one captured program.  ``backend`` is
    ``"torch-fused"`` (the default), ``"torch"`` (batched GP solves on
    ``device``) or ``"numpy"`` (the host solver; ``device`` is not read);
    ``"jnp"``/``"jnp-fused"`` raise ``ValueError`` naming these.  A device
    backend on a card that is missing, or a device string that cannot be
    read, raises ``RuntimeError`` here, never in the dispatcher.

    m=J batches whose rows are *all* warm skip the Gen-C-seeded joint
    restart (``restart_warm_joint=True`` re-enables it): each warm seed is
    itself a post-restart best KKT point, so re-running the companion
    solves can only reproduce it.
    """

    def __init__(self, max_batch: int = 16, window_s: float = 0.02,
                 backend: str = "torch-fused", tol: float = 1e-4,
                 max_iter: int = 60, cache_size: int = 4096,
                 warm_radius: float = 0.05, restart_warm_joint: bool = False,
                 quarantine_retries: int = 2, retry_base_s: float = 0.05,
                 retry_cap_s: float = 1.0, start: bool = True,
                 device="cuda"):
        refuse_jax_backend(backend)
        if backend not in _BACKENDS:
            raise ValueError(f"unknown solver backend {backend!r}; expected "
                             f"one of {_BACKENDS}")
        # a missing card fails here: inside the dispatcher it would be
        # bisected, quarantined and reported as a poisoned request
        self.device = device if backend == "numpy" else resolve_device(device)
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self.backend = backend
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.warm_radius = float(warm_radius)
        self.restart_warm_joint = bool(restart_warm_joint)
        self.quarantine_retries = int(quarantine_retries)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.cache = PlanCache(maxsize=cache_size)
        self._cond = threading.Condition()
        self._queues: Dict[tuple, "collections.deque[PlanHandle]"] = {}
        self._closing = False
        # the server's own always-on registry: stats() is a public API, so
        # its instruments record regardless of the global obs switch
        self.metrics = MetricsRegistry()
        self._queue_depth = 0            # queued handles (under _cond)
        self._inflight = 0               # taken but unresolved (under _cond)
        self._trace_base: Dict[tuple, Tuple[tuple, int]] = {}
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- metric shorthands (get-or-create is cheap: one dict lookup) ----
    def _count(self, name: str, n: float = 1, **labels):
        self.metrics.counter("planserver." + name, **labels).inc(n)

    def _observe(self, name: str, v: float, **labels):
        self.metrics.histogram("planserver." + name, **labels).observe(v)

    def _set_gauges(self):
        self.metrics.gauge("planserver.queue_depth").set(self._queue_depth)
        self.metrics.gauge("planserver.inflight").set(self._inflight)

    def _request_done(self, h: PlanHandle, latency: bool = True):
        """Per-request bookkeeping after a taken handle resolves (or is
        dropped): inflight gauge, per-source latency histogram, and — when
        global tracing is on — the request's queue→solve async spans."""
        with self._cond:
            self._inflight -= 1
            self._set_gauges()
        if latency and h.t_done is not None and h.source is not None:
            self._observe("latency_s", h.latency_s, source=h.source)
            self._observe("latency_s", h.latency_s, source="all")
        if _OBS_ON.on and h.t_taken is not None and h.t_done is not None:
            rid = id(h)
            _otrace.async_span("planserver.queue", rid, h.t_submit,
                               h.t_taken, cat="planserver",
                               source=h.source or "?")
            _otrace.async_span("planserver.solve", rid, h.t_taken, h.t_done,
                               cat="planserver", source=h.source or "?",
                               error=h.error)

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="planserver", daemon=True)
        self._thread.start()
        return self

    def close(self):
        """Drain every pending request, then stop the dispatcher."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- submission ----------------------------------------------------
    def submit(self, scenario, m=None) -> PlanHandle:
        """Admit one ``Scenario.optimize`` request; returns immediately."""
        m = scenario._resolve(m)
        problem = scenario.problem(m)
        sig = structure_signature(problem)
        vec = fingerprint(problem)
        fp = _quantize(vec)
        h = PlanHandle(scenario, m, problem, sig, vec, fp)
        hit = self.cache.get(sig, fp)
        if hit is not None:
            h.source = "hit"
            h.converged = True          # only converged results are cached
            h.plan = scenario._plan_from_result(m, hit.result)
            self._count("submitted")
            self._count("requests", source="hit")
            h._resolve()
            self._observe("latency_s", h.latency_s, source="hit")
            self._observe("latency_s", h.latency_s, source="all")
            if _OBS_ON.on:
                _otrace.instant("planserver.hit")
            return h
        near, dist = self.cache.nearest(sig, vec)
        if near is not None and dist <= self.warm_radius:
            h.source, h.warm_dist, h.z0 = "warm", dist, near.result.z
        else:
            h.source = "cold"
        with self._cond:
            if self._closing:
                raise RuntimeError("PlanServer is closed")
            self._queues.setdefault(sig, collections.deque()).append(h)
            self._queue_depth += 1
            self._set_gauges()
            self._cond.notify_all()
        self._count("submitted")
        self._count("requests", source=h.source)
        return h

    def solve(self, scenario, m=None, timeout: Optional[float] = None):
        """Blocking convenience: ``submit(...).result(...)``."""
        return self.submit(scenario, m=m).result(timeout)

    def solve_many(self, scenarios: Sequence, timeout: Optional[float] = None
                   ) -> List:
        handles = [self.submit(s) for s in scenarios]
        return [h.result(timeout) for h in handles]

    # -- dispatcher ----------------------------------------------------
    def _take_batch(self) -> Optional[List[PlanHandle]]:
        """Under the lock: pop the most overdue ready batch, or None."""
        now = time.perf_counter()
        ready_sig, oldest = None, None
        for sig, q in self._queues.items():
            if not q:
                continue
            t0 = q[0].t_submit
            if (len(q) >= self.max_batch or self._closing
                    or now - t0 >= self.window_s):
                if oldest is None or t0 < oldest:
                    ready_sig, oldest = sig, t0
        if ready_sig is None:
            return None
        q = self._queues[ready_sig]
        batch: List[PlanHandle] = []
        while q and len(batch) < self.max_batch:
            h = q.popleft()
            self._queue_depth -= 1
            if h.cancelled:             # withdrawn while queued: free slot
                self._count("cancelled")
                continue
            h.t_taken = now
            self._observe("queue_wait_s", now - h.t_submit)
            batch.append(h)
        self._inflight += len(batch)
        self._set_gauges()
        return batch or None

    def _next_deadline(self) -> Optional[float]:
        ts = [q[0].t_submit + self.window_s
              for q in self._queues.values() if q]
        return min(ts) if ts else None

    def _dispatch_loop(self):
        while True:
            with self._cond:
                batch = self._take_batch()
                while batch is None:
                    if self._closing and not any(self._queues.values()):
                        return
                    dl = self._next_deadline()
                    self._cond.wait(
                        None if dl is None
                        else max(1e-4, dl - time.perf_counter()))
                    batch = self._take_batch()
            self._solve_batch(batch)

    def _captures(self, key: tuple) -> int:
        if self.backend != "torch-fused":
            return 0
        from ..opt import gia_fused
        return gia_fused.capture_count(key)

    def _solve_batch(self, batch: List[PlanHandle]):
        sig = batch[0].sig
        if sig not in self._trace_base:
            key = RefreshPlan.build([batch[0].problem]).signature_key
            self._trace_base[sig] = (key, self._captures(key))
        self._observe("batch_rows", len(batch))
        with _otrace.span("planserver.batch", rows=len(batch),
                          sig="/".join(map(str, sig))[:120]):
            self._solve_rows(batch)

    def _dispatch(self, rows: List[PlanHandle], restart: bool) -> list:
        """One solver call over ``rows`` at the server's fixed shape."""
        pad = self.max_batch if self.backend == "torch-fused" else 0
        return solve_param_opt_batched(
            [h.problem for h in rows], z0s=[h.z0 for h in rows],
            tol=self.tol, max_iter=self.max_iter, backend=self.backend,
            joint_restart=restart, pad_to=pad, device=self.device)

    def _solve_rows(self, rows: List[PlanHandle]):
        """Solve ``rows`` as one fused dispatch, bisecting on failure.

        One poison row (corrupt warm seed, NaN coefficients, ...) must not
        take its batch peers down with it: on a solver exception the rows
        are split in half and retried, so every healthy row re-converges in
        O(log n) re-dispatches while the poison row is isolated down to a
        singleton and handed to :meth:`_solve_quarantined`.  Every
        re-dispatch pads to the same ``max_batch`` device shape, so the
        splitting never costs an extra capture.
        """
        joint = rows[0].problem.m is Objective.JOINT
        all_warm = all(h.source == "warm" for h in rows)
        restart = not (joint and all_warm and not self.restart_warm_joint)
        try:
            results = self._dispatch(rows, restart)
        except Exception:                           # noqa: BLE001
            if len(rows) == 1:
                self._solve_quarantined(rows[0])
                return
            self._count("bisections")
            mid = len(rows) // 2
            self._solve_rows(rows[:mid])
            self._solve_rows(rows[mid:])
            return
        for h, r in zip(rows, results):
            self._finish(h, r, len(rows))

    def _solve_quarantined(self, h: PlanHandle):
        """Last resort for an isolated failing row: retry it solo with
        capped exponential backoff — transient failures (allocator
        pressure, cache races) usually clear, and the row keeps its own
        warm seed — then error the handle."""
        self._count("quarantined")
        joint = h.problem.m is Objective.JOINT
        restart = not (joint and h.source == "warm"
                       and not self.restart_warm_joint)
        delay, err = self.retry_base_s, None
        for attempt in range(self.quarantine_retries + 1):
            if attempt:
                time.sleep(delay)
                delay = min(delay * 2.0, self.retry_cap_s)
            try:
                r = self._dispatch([h], restart)[0]
            except Exception as e:                  # noqa: BLE001
                err = e
                continue
            self._finish(h, r, 1)
            return
        self._count("poisoned")
        h.error = f"{type(err).__name__}: {err}"
        h._resolve()
        self._request_done(h)

    def _finish(self, h: PlanHandle, r: GIAResult, batch_size: int):
        """Resolve one solved row: freeze its Plan, record convergence,
        cache the converged result.  A row cancelled mid-solve is already
        resolved with ``error="cancelled"`` — leave it alone."""
        if h.cancelled:
            self._request_done(h, latency=False)
            return
        try:
            h.plan = h.scenario._plan_from_result(h.m, r)
        except Exception as e:                      # noqa: BLE001
            # a row whose *plan construction* blows up is as poisonous as
            # one that kills the solver — contain it, don't unwind the
            # dispatcher with sibling rows still unresolved
            self._count("poisoned")
            h.error = f"{type(e).__name__}: {e}"
            h._resolve()
            self._request_done(h)
            return
        h.batch_size = batch_size
        h.converged = bool(r.converged)
        if r.converged:
            self.cache.put(h.sig, h.fp, _CacheEntry(h.vec, r))
        else:
            self._count("non_converged")
        h._resolve()
        self._request_done(h)

    # -- introspection -------------------------------------------------
    def compile_counts(self) -> Dict[tuple, int]:
        """Step-program captures attributed to this server, per signature —
        the "one capture per distinct signature" assertion reads this
        (``"numpy"``/``"torch"`` capture nothing: 0 per signature)."""
        return {sig: self._captures(key) - base
                for sig, (key, base) in self._trace_base.items()}

    def stats(self) -> dict:
        """A view over the server's always-on metrics registry.

        ``queue_depth``/``inflight`` expose the live dispatcher state, and
        ``queue_wait_s``/``latency_s`` are percentile summaries
        (``latency_s`` is keyed by request source, plus an ``"all"``
        aggregate); ``compiles`` is :meth:`compile_counts` by signature."""
        def count(name, **labels):
            return int(self.metrics.counter("planserver." + name,
                                            **labels).value)

        submitted = count("submitted")
        hits = count("requests", source="hit")
        batch_h = self.metrics.histogram("planserver.batch_rows")
        lat = {}
        for src in ("hit", "warm", "cold", "all"):
            s = self.metrics.histogram("planserver.latency_s",
                                       source=src).summary()
            if s["count"]:
                lat[src] = s
        return {
            "submitted": submitted,
            "hits": hits,
            "warm": count("requests", source="warm"),
            "cold": count("requests", source="cold"),
            "hit_rate": hits / submitted if submitted else 0.0,
            "batches": batch_h.count,
            "mean_batch": batch_h.mean if batch_h.count else 0.0,
            "cancelled": count("cancelled"),
            "bisections": count("bisections"),
            "quarantined": count("quarantined"),
            "poisoned": count("poisoned"),
            "non_converged": count("non_converged"),
            "signatures": len(self._trace_base),
            "cache_entries": len(self.cache),
            "compiles": {"/".join(map(str, sig)): c
                         for sig, c in self.compile_counts().items()},
            "queue_depth": int(self.metrics.gauge(
                "planserver.queue_depth").value),
            "inflight": int(self.metrics.gauge(
                "planserver.inflight").value),
            "queue_wait_s": self.metrics.histogram(
                "planserver.queue_wait_s").summary(),
            "latency_s": lat,
        }
