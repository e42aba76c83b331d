"""The FaultModel interface: stochastic worker behavior — stragglers,
crashes, corrupted payloads — as a first-class, pluggable piece of both
the optimizer and the runtimes.

The paper's cost model assumes every worker delivers its quantized update
every round at its nominal CPU frequency and rate, but on real edge
fleets those capabilities are *stochastic*.  A :class:`FaultModel`
bundles the seams a fault process needs, mirroring how
:class:`repro.sampling.SamplingModel` wraps participation:

  planning hooks     ``availability`` / ``freq_margin`` / ``rate_margin``
                     — the coefficients the GP plans *for* faults with:
                     per-worker availability ``a_n`` (the probability a
                     worker's update is usable at all — crash/corruption,
                     *not* deadline misses, see below) inflates the
                     convergence variance blocks by the same exact ratio
                     form as client sampling with ``pi_n -> a_n pi_n``;
                     the uncertainty margins derate ``F_n``/``r_n`` so the
                     time constraint becomes worst-case-over-the-box
                     (still posynomial — monotone in F_n, r_n);
  runtime hooks      ``init_state`` / ``draw_round`` — the seeded,
                     deterministic per-round fault draw (latency
                     multipliers, crash mask, corruption mask) consumed by
                     the shared :class:`FaultDriver`, which both runtimes
                     (:mod:`repro.core.genqsgd` and
                     :mod:`repro.train.trainer`) drive round by round;
  delivery hook      ``deliver_prob`` — the exact per-worker probability
                     that an *attempted* update survives the round
                     (up, uncorrupted, inside the deadline), used for the
                     unbiased Horvitz-Thompson reweighting below.

**Deadline aggregation.**  Each round gets a deadline ``tau =
deadline_slack * (the Plan's predicted round time)``.  Workers past the
deadline (or crashed, or failing checksum) are excluded and the survivors
re-aggregated with unbiased HT weights ``mask_n * w_n / (pi_n *
deliver_p_n)`` — :func:`repro.sampling.base.cohort_weights` verbatim,
divided by the delivery probability — so a timed-out worker is treated
exactly like a non-sampled one and the aggregate stays an unbiased
estimate of the full blocking round.  With no fault model configured the
runtimes never construct a driver and are bit-identical to the historical
blocking sync (asserted by ``tests/unit/test_faults.py``).

**Why availability excludes deadline misses.**  The deadline depends on
the *optimized* plan (tau scales the predicted round time), so folding
straggler-deadline exclusion into the GP's availability would make the
coefficients depend on the solution.  The split that keeps the GP a plain
coefficient refresh: ``availability`` carries only the state-independent
part (crash stationary probability x corruption survival); the
straggler-deadline term enters ``deliver_prob`` — computed *after* the
solve, from the frozen plan's worker times — which only the runtime's HT
weights consume.  The energy objective is deliberately unchanged by
faults: a worker that attempts the round pays its compute/upload energy
whether or not its update survives (a conservative modeling choice,
noted in ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np

from ..obs import REGISTRY as _METRICS
from ..obs.metrics import GLOBAL_SWITCH as _OBS_ON
from ..sampling.base import cohort_weights

__all__ = ["FaultModel", "RoundFaults", "RoundFaultRecord", "FaultTrace",
           "FaultSpec", "FaultDriver", "fault_rng", "payload_checksum",
           "flip_bits"]

#: salt separating the fault rng stream from the cohort-draw stream (both
#: are seeded from the same user seed; the streams must never alias)
_FAULT_SALT = 0xFA017


def fault_rng(seed) -> np.random.Generator:
    """The ONE fault-stream constructor both runtimes use: same seed =>
    same per-round fault draws on the reference and SPMD backends."""
    return np.random.default_rng(
        None if seed is None else (int(seed), _FAULT_SALT))


# ---------------------------------------------------------------------------
# payload integrity (checksum-detected bit flips)
# ---------------------------------------------------------------------------
def payload_checksum(arr) -> int:
    """CRC-32 over the raw bytes of a payload array — the integrity check
    a server runs on each received update; any single bit flip changes it."""
    return zlib.crc32(np.ascontiguousarray(np.asarray(arr)).tobytes()) \
        & 0xFFFFFFFF


def flip_bits(arr, rng: np.random.Generator, n_flips: int = 1) -> np.ndarray:
    """``arr`` with ``n_flips`` uniformly chosen bits flipped (a corrupted
    copy; the input is untouched)."""
    a = np.ascontiguousarray(np.asarray(arr)).copy()
    raw = a.view(np.uint8).reshape(-1)
    pos = rng.integers(0, raw.size, size=int(n_flips))
    bit = rng.integers(0, 8, size=int(n_flips))
    raw[pos] ^= (np.uint8(1) << bit.astype(np.uint8))
    return a


# ---------------------------------------------------------------------------
# per-round fault draw + trace records
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RoundFaults:
    """One round's drawn faults, per worker (length-N arrays)."""
    latency_mult: np.ndarray     # float >= 1; straggler inflation factors
    crashed: np.ndarray          # bool; down this round (no upload at all)
    corrupt: np.ndarray          # bool; upload arrives but fails checksum


@dataclasses.dataclass(frozen=True)
class RoundFaultRecord:
    """What one round realized under faults (index tuples are sorted)."""
    round: int
    cohort: Tuple[int, ...]      # workers the round attempted (sampled cohort)
    delivered: Tuple[int, ...]   # survivors the server aggregated
    straggled: Tuple[int, ...]   # attempted workers with inflated latency
    crashed: Tuple[int, ...]     # attempted workers that were down
    corrupt: Tuple[int, ...]     # attempted workers failing the checksum
    deadline: float              # this round's aggregation deadline tau (s)
    t_round: float               # realized round time min(tau, blocking)
    t_blocking: float            # what blocking sync would have waited (s)

    @property
    def n_dropped(self) -> int:
        return len(self.cohort) - len(self.delivered)


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """The per-round fault record of one training run (frozen)."""
    records: Tuple[RoundFaultRecord, ...] = ()

    def __len__(self) -> int:
        return len(self.records)

    @property
    def rounds_degraded(self) -> int:
        """Rounds where at least one attempted worker was excluded."""
        return sum(1 for r in self.records if r.n_dropped > 0)

    @property
    def workers_dropped(self) -> int:
        """Total worker-rounds excluded (timed out / crashed / corrupt)."""
        return sum(r.n_dropped for r in self.records)

    @property
    def realized_time(self) -> float:
        """Sum of realized round times under deadline aggregation."""
        return float(sum(r.t_round for r in self.records))

    @property
    def blocking_time(self) -> float:
        """What blocking sync would have waited over the same fault draws
        (infinite if any attempted worker crashed in any round)."""
        return float(sum(r.t_blocking for r in self.records))

    @property
    def mean_round_time(self) -> float:
        return self.realized_time / max(1, len(self.records))

    def summary(self) -> str:
        n = len(self.records)
        return (f"FaultTrace[{n} rounds] {self.rounds_degraded} degraded, "
                f"{self.workers_dropped} worker-rounds dropped, realized "
                f"{self.realized_time:.4g}s vs blocking "
                f"{self.blocking_time:.4g}s")


# ---------------------------------------------------------------------------
# the model interface
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One fault process; frozen so instances key registries/caches.

    The base class *is* the fault-free fleet: every hook returns the
    neutral value selecting the historical code path bitwise.
    """

    key: str = "none"             # registry name == structure-signature key
    #: aggregation deadline as a multiple of the plan's predicted round
    #: time; inf = blocking sync (wait for every attempted worker)
    deadline_slack: float = float("inf")
    #: worst-case derating of worker CPU frequencies: the time constraint
    #: prices F_n (1 - freq_margin) — worst case over the uncertainty box
    freq_margin: float = 0.0
    #: ditto for worker uplink rates r_n
    rate_margin: float = 0.0
    #: how the runtime sets each round's tau: ``"frozen"`` keeps the plan's
    #: ``tau = slack x predicted round time`` for every round (the
    #: historical path, bitwise); ``"adaptive"`` re-estimates tau from an
    #: EMA of *realized* round times — ``tau_k = slack x ema_{k-1}``, with
    #: the per-round delivery probabilities recomputed at tau_k so the HT
    #: reweighting stays unbiased (tau_k depends only on past rounds, so
    #: conditional on them round k's aggregate is still unbiased)
    deadline: str = "frozen"
    #: EMA weight on the newest realized round time (adaptive mode only)
    ema_alpha: float = 0.25

    # -- identity --------------------------------------------------------
    def validate(self, N: int) -> None:
        """Fail loudly on an invalid model (bad probabilities, slack < 1)."""
        del N
        if not self.deadline_slack >= 1.0:
            raise ValueError(
                f"deadline_slack={self.deadline_slack} must be >= 1 (the "
                f"deadline is slack x the predicted round time; below 1 "
                f"even nominal workers miss it)")
        for name in ("freq_margin", "rate_margin"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name}={v} outside [0, 1)")
        if self.deadline not in ("frozen", "adaptive"):
            raise ValueError(
                f"deadline={self.deadline!r} must be 'frozen' or 'adaptive'")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha={self.ema_alpha} outside (0, 1]")
        if self.deadline == "adaptive" and not np.isfinite(
                self.deadline_slack):
            raise ValueError(
                "deadline='adaptive' needs a finite deadline_slack — the "
                "adaptive tau is slack x the realized-round-time EMA, and "
                "an infinite slack is blocking sync with nothing to adapt")

    def is_neutral(self, N: int) -> bool:
        """True when the model is a fault-free fleet in disguise — every
        hook must then return its neutral value so the pipeline is
        bit-identical to the unfaulted one."""
        del N
        return True

    def signature(self, N: int) -> tuple:
        """The structure-signature element.  Neutral models report
        ``("none",)`` so they share the default problems' compile/cache
        pools; genuinely faulty models must differ from it."""
        del N
        return ("none",)

    def runtime_active(self, N: int) -> bool:
        """Whether the runtimes need a :class:`FaultDriver` at all (False
        for margin-only models: they reshape the GP, not the rounds)."""
        del N
        return False

    # -- optimizer: availability coefficients ----------------------------
    def availability(self, N: int) -> Optional[np.ndarray]:
        """Per-worker probability ``a_n`` that an attempted update is
        usable (up and uncorrupted) — the state-independent part only;
        deadline misses live in :meth:`deliver_prob` (see the module
        docstring).  None = every worker always usable, bitwise."""
        del N
        return None

    # -- runtime: seeded per-round draws ---------------------------------
    def init_state(self, N: int):
        """Initial cross-round fault state (e.g. remaining down-rounds)."""
        del N
        return None

    def draw_round(self, rng: np.random.Generator, N: int, state
                   ) -> Tuple[RoundFaults, object]:
        """One round's seeded fault draw -> ``(faults, next_state)``.

        Implementations must consume a state-independent amount of the rng
        stream so traces replay deterministically from the seed alone."""
        del rng, state
        return RoundFaults(latency_mult=np.ones(N),
                           crashed=np.zeros(N, bool),
                           corrupt=np.zeros(N, bool)), None

    def deliver_prob(self, worker_times: np.ndarray, deadline: float
                     ) -> np.ndarray:
        """Exact per-worker probability an attempted update survives the
        round (up, uncorrupted, arrival <= deadline) given the nominal
        worker times of the frozen plan."""
        return np.ones(np.asarray(worker_times).shape[0])


# ---------------------------------------------------------------------------
# the frozen per-plan fault contract
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Everything a runtime needs to inject faults for ONE frozen plan:
    the model, the plan's nominal per-worker round times, the aggregation
    deadline ``tau = slack x predicted round time``, and the exact
    delivery probabilities the HT reweighting divides by.  Built by
    ``Scenario._plan_from_result`` (which owns the cost model), frozen
    into the :class:`~repro.api.plan.Plan`."""

    model: FaultModel
    worker_times: Tuple[float, ...]   # t_n = B (C_n/F_n) K_n + M_sn/r_n
    deadline: float                   # tau (s); inf = blocking sync
    deliver_p: Tuple[float, ...]      # P[attempted update survives]

    def __post_init__(self):
        object.__setattr__(self, "worker_times",
                           tuple(float(t) for t in self.worker_times))
        object.__setattr__(self, "deliver_p",
                           tuple(float(p) for p in self.deliver_p))
        if len(self.deliver_p) != len(self.worker_times):
            raise ValueError(
                f"{len(self.deliver_p)} delivery probabilities for "
                f"{len(self.worker_times)} worker times")
        if any(t < 0 for t in self.worker_times):
            raise ValueError(f"negative worker time in {self.worker_times}")
        if not self.deadline > 0:
            raise ValueError(f"deadline={self.deadline} must be positive")
        if any(not 0.0 < p <= 1.0 for p in self.deliver_p):
            raise ValueError(
                f"delivery probabilities must be in (0, 1] — a worker with "
                f"zero survival probability cannot be reweighted unbiasedly "
                f"(raise deadline_slack); got {self.deliver_p}")

    @property
    def N(self) -> int:
        return len(self.worker_times)


# ---------------------------------------------------------------------------
# the shared runtime driver
# ---------------------------------------------------------------------------
class FaultDriver:
    """Round-by-round fault injection + deadline-HT delivery.

    Both runtimes (the reference :meth:`repro.core.genqsgd.GenQSGD.run`
    and the SPMD :meth:`repro.train.trainer.GenQSGDTrainer.run`) drive one
    of these with the *same* seeded rng construction (:func:`fault_rng`),
    so a (seed, model) pair produces the bit-identical
    :class:`FaultTrace` on either backend.

    ``step`` composes with client sampling: pass the round's cohort
    ``(idx, pi)`` and the returned aggregation vector is
    ``cohort_weights(idx, pi, N, w) * delivered_mask / deliver_p`` — PR
    7's Horvitz-Thompson weights divided by the delivery probability, so
    ``E[sum_n u_n d_n] = sum_n w_n d_n`` over both the cohort draw and
    the fault draw.

    **Adaptive deadline** (``model.deadline == "adaptive"``): tau is
    re-estimated each round as ``slack x ema`` of the *realized* round
    times, seeded at the plan's predicted round time (so round 0 is
    bitwise the frozen tau) and floored at the nominal blocking time
    ``max_n t_n`` — the floor keeps every attempted worker's delivery
    probability positive, which the HT reweighting needs (the same
    invariant FaultSpec validates for the frozen tau).  The delivery
    probabilities are recomputed at each round's tau; since tau_k is a
    function of rounds < k only, round k's aggregate stays conditionally
    unbiased.  Note the EMA averages *censored* times (``t_round <=
    tau``): rounds that finish early pull tau down toward ``slack x``
    the typical round time (floored as above), while rounds cut at the
    deadline feed ``t_round = tau`` back in, growing the EMA by
    ``1 + alpha (slack - 1)`` per cut round until tau covers the typical
    blocking time — tau tracks the realized regime in both directions.
    """

    def __init__(self, spec: FaultSpec, N: int, agg_weights=None):
        if spec.N != N:
            raise ValueError(f"FaultSpec describes {spec.N} workers, "
                             f"runtime has {N}")
        self.spec = spec
        self.N = int(N)
        self.agg_weights = agg_weights
        self.state = spec.model.init_state(N)
        self.records = []
        self._t = np.asarray(spec.worker_times, np.float64)
        self._dp = np.asarray(spec.deliver_p, np.float64)
        # instruments are cheap switch-gated handles: resolve them once
        # here so the per-round cost is one attribute check, not three
        # registry lookups
        self._m_round_s = _METRICS.histogram("faults.round_s",
                                             model=spec.model.key)
        self._m_dropped = _METRICS.counter("faults.dropped",
                                           model=spec.model.key)
        self._m_cuts = _METRICS.counter("faults.deadline_cuts",
                                        model=spec.model.key)
        self._adaptive = getattr(spec.model, "deadline", "frozen") \
            == "adaptive"
        if self._adaptive:
            self._slack = float(spec.model.deadline_slack)
            self._alpha = float(spec.model.ema_alpha)
            # seeded at the plan's prediction: spec.deadline / slack is the
            # predicted round time, so the first adaptive tau IS the frozen
            # tau and the modes only diverge as realized times arrive
            self._ema = float(spec.deadline) / self._slack
            self._tau_floor = float(np.max(self._t))

    def step(self, rng: np.random.Generator, round_no: int,
             idx=None, pi=None) -> np.ndarray:
        """Draw one round's faults; return the length-N aggregation vector
        ``u`` (and append the round's :class:`RoundFaultRecord`)."""
        N = self.N
        faults, self.state = self.spec.model.draw_round(rng, N, self.state)
        if idx is None:                       # full participation
            idx = np.arange(N)
            pi = np.ones(N)
        attempted = np.zeros(N, bool)
        attempted[idx] = True
        arrival = np.where(faults.crashed, np.inf,
                           faults.latency_mult * self._t)
        if self._adaptive:
            deadline = max(self._slack * self._ema, self._tau_floor)
            dp = np.maximum(
                self.spec.model.deliver_prob(self._t, deadline), 1e-12)
        else:
            deadline = self.spec.deadline
            dp = self._dp
        # blocking sync waits for the slowest attempted worker (inf if one
        # crashed); deadline aggregation cuts the round at tau
        t_blocking = float(np.max(np.where(attempted, arrival, -np.inf)))
        t_round = float(min(deadline, t_blocking))
        if self._adaptive:
            self._ema += self._alpha * (t_round - self._ema)
        on_time = (arrival <= deadline) & ~faults.crashed
        delivered = attempted & on_time & ~faults.corrupt
        u = cohort_weights(np.asarray(idx), np.asarray(pi), N,
                           self.agg_weights)
        u = np.where(delivered, u / dp, 0.0)
        straggled = attempted & (faults.latency_mult > 1.0) & ~faults.crashed
        self.records.append(RoundFaultRecord(
            round=int(round_no),
            cohort=tuple(int(i) for i in np.flatnonzero(attempted)),
            delivered=tuple(int(i) for i in np.flatnonzero(delivered)),
            straggled=tuple(int(i) for i in np.flatnonzero(straggled)),
            crashed=tuple(int(i) for i in
                          np.flatnonzero(attempted & faults.crashed)),
            corrupt=tuple(int(i) for i in
                          np.flatnonzero(attempted & faults.corrupt)),
            deadline=float(deadline), t_round=t_round,
            t_blocking=t_blocking))
        if _OBS_ON.on:
            self._m_round_s.observe(t_round)
            self._m_dropped.inc(self.records[-1].n_dropped)
            if t_blocking > deadline:
                self._m_cuts.inc()
        return u

    @property
    def last(self) -> RoundFaultRecord:
        return self.records[-1]

    def trace(self) -> FaultTrace:
        return FaultTrace(records=tuple(self.records))
