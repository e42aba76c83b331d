"""Built-in fault models: the fault-free fleet and the edge-fleet model
(stragglers + multi-round crashes + payload corruption)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .base import FaultModel, RoundFaults

__all__ = ["NoFaults", "EdgeFaults", "edge_faults"]


@dataclasses.dataclass(frozen=True)
class NoFaults(FaultModel):
    """The fault-free fleet — every hook neutral; selecting it is
    bit-identical to configuring no fault model at all."""

    key: str = "none"


@dataclasses.dataclass(frozen=True)
class EdgeFaults(FaultModel):
    """The edge-fleet fault process — three independent mechanisms, all
    driven by one seeded stream with a fixed per-round draw order (crash,
    straggle, corrupt; every mask drawn every round regardless of state,
    so traces replay deterministically from the seed alone):

    stragglers   each attempted worker independently inflates its round
                 latency by ``straggler_factor`` with probability
                 ``straggler_prob`` (i.i.d. across rounds and workers);
    crashes      a worker goes down with probability ``crash_prob`` per
                 up-round and stays down for ``crash_rounds`` consecutive
                 rounds (a Markov chain whose state is the remaining
                 down-rounds; ``crash_rounds=1`` is i.i.d. Bernoulli
                 dropout).  Stationary up-fraction
                 ``(1-q) / (1-q + q R)``;
    corruption   a delivered payload independently fails its checksum
                 with probability ``corrupt_prob``.

    ``availability`` reports the stationary up-fraction x checksum
    survival (the chain *starts* all-up, so early rounds of a long-R model
    are slightly more available than the stationary value the GP plans
    with — exact for ``crash_rounds=1``).  Straggler-deadline exclusion
    deliberately stays out of availability and enters ``deliver_prob``
    instead; see :mod:`repro_torch.faults.base` for why.
    """

    key: str = "edge"
    straggler_prob: float = 0.0
    straggler_factor: float = 1.0
    crash_prob: float = 0.0
    crash_rounds: int = 1
    corrupt_prob: float = 0.0

    # -- identity --------------------------------------------------------
    def validate(self, N: int) -> None:
        super().validate(N)
        for name in ("straggler_prob", "crash_prob", "corrupt_prob"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name}={v} outside [0, 1)")
        if not self.straggler_factor >= 1.0:
            raise ValueError(
                f"straggler_factor={self.straggler_factor} must be >= 1 "
                f"(a straggler is slower than nominal, not faster)")
        if not (isinstance(self.crash_rounds, (int, np.integer))
                and self.crash_rounds >= 1):
            raise ValueError(
                f"crash_rounds={self.crash_rounds} must be an int >= 1")

    def is_neutral(self, N: int) -> bool:
        return (not self.runtime_active(N)
                and self.freq_margin == 0.0 and self.rate_margin == 0.0)

    def signature(self, N: int) -> tuple:
        if self.is_neutral(N):
            return ("none",)
        return (self.key, float(self.straggler_prob),
                float(self.straggler_factor), float(self.crash_prob),
                int(self.crash_rounds), float(self.corrupt_prob),
                float(self.deadline_slack), float(self.freq_margin),
                float(self.rate_margin))

    def runtime_active(self, N: int) -> bool:
        del N
        return (self.straggler_prob > 0.0 and self.straggler_factor > 1.0) \
            or self.crash_prob > 0.0 or self.corrupt_prob > 0.0

    # -- optimizer coefficients ------------------------------------------
    @property
    def _up_frac(self) -> float:
        q, R = self.crash_prob, self.crash_rounds
        return (1.0 - q) / (1.0 - q + q * R)

    def availability(self, N: int) -> Optional[np.ndarray]:
        a = self._up_frac * (1.0 - self.corrupt_prob)
        if a == 1.0:
            return None          # straggler-only models don't touch the GP
        return np.full(N, a)

    # -- runtime draws ---------------------------------------------------
    def init_state(self, N: int):
        return np.zeros(N, np.int64)       # remaining down-rounds: all up

    def draw_round(self, rng: np.random.Generator, N: int, state
                   ) -> Tuple[RoundFaults, object]:
        # fixed draw order + unconditional draws: the stream position after
        # a round never depends on what was drawn, so a trace is a pure
        # function of (seed, round count)
        r_crash = rng.random(N)
        r_straggle = rng.random(N)
        r_corrupt = rng.random(N)
        down_now = state > 0
        nxt = np.maximum(state - 1, 0)
        newly = (~down_now) & (r_crash < self.crash_prob)
        crashed = down_now | newly
        nxt = np.where(newly, self.crash_rounds - 1, nxt)
        straggle = r_straggle < self.straggler_prob
        mult = np.where(straggle, self.straggler_factor, 1.0)
        corrupt = r_corrupt < self.corrupt_prob
        return RoundFaults(latency_mult=mult, crashed=crashed,
                           corrupt=corrupt), nxt

    def deliver_prob(self, worker_times, deadline: float) -> np.ndarray:
        t = np.asarray(worker_times, np.float64)
        p_up = self._up_frac
        p_ok = 1.0 - self.corrupt_prob
        # arrival = mult * t_n with mult in {1, factor}; slack >= 1
        # guarantees t_n <= deadline, so only the straggled arrival can miss
        p_time = np.where(self.straggler_factor * t <= deadline, 1.0,
                          np.where(t <= deadline,
                                   1.0 - self.straggler_prob, 0.0))
        return p_up * p_ok * p_time


def edge_faults(straggler_prob: float = 0.0, straggler_factor: float = 1.0,
                crash_prob: float = 0.0, crash_rounds: int = 1,
                corrupt_prob: float = 0.0,
                deadline_slack: float = float("inf"),
                freq_margin: float = 0.0,
                rate_margin: float = 0.0,
                deadline: str = "frozen",
                ema_alpha: float = 0.25) -> EdgeFaults:
    """Factory for :class:`EdgeFaults` (keyword-friendly mirror of
    :func:`repro_torch.sampling.uniform` / ``importance``).

    ``deadline="adaptive"`` makes the runtime's :class:`FaultDriver`
    re-estimate tau each round from an EMA (weight ``ema_alpha``) of the
    realized round times; the default ``"frozen"`` keeps the plan's tau
    for every round, bitwise the historical behavior."""
    return EdgeFaults(straggler_prob=float(straggler_prob),
                      straggler_factor=float(straggler_factor),
                      crash_prob=float(crash_prob),
                      crash_rounds=int(crash_rounds),
                      corrupt_prob=float(corrupt_prob),
                      deadline_slack=float(deadline_slack),
                      freq_margin=float(freq_margin),
                      rate_margin=float(rate_margin),
                      deadline=str(deadline),
                      ema_alpha=float(ema_alpha))
