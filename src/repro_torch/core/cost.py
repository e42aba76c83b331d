"""Time and energy cost models (Sec. IV-A, eqs. (17), (18)) for a
heterogeneous edge system.

    T(K, B) = K0 * ( B * max_n (C_n / F_n) * K_n
                     + C_0 / F_0
                     + max_n (M_{s_n} / r_n)
                     + M_{s_0} / r_0 )

    E(K, B) = K0 * ( B * sum_n alpha_n C_n F_n^2 K_n
                     + alpha_0 C_0 F_0^2
                     + sum_{n in N̄} p_n M_{s_n} / r_n )

The closed forms are the paper's, with Sec.-VII edge constants.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np

from ..compress import make_codec, q_pair

__all__ = ["EdgeSystem", "time_cost", "energy_cost"]


@dataclasses.dataclass(frozen=True)
class EdgeSystem:
    """System parameters for server (index 0) and N workers (Remark 1)."""
    # server
    F0: float          # CPU frequency (cycles/s) or FLOP/s-equivalent
    C0: float          # cycles per global model update
    p0: float          # transmit power (W)
    r0: float          # multicast rate (b/s)
    s0: Optional[int]  # server quantization parameter (None = no quantization)
    alpha0: float      # switched-capacitance factor
    # workers (arrays of length N)
    Fn: np.ndarray
    Cn: np.ndarray
    pn: np.ndarray
    rn: np.ndarray
    sn: Sequence[Optional[int]]
    alphan: np.ndarray
    # model dimension (for M_s)
    dim: int
    # quantization-bucket dimension for q_s (QSGD bucketing: per-bucket norms;
    # Assumption 1 holds per bucket exactly as per tensor).  None = whole-dim.
    q_dim: Optional[int] = None
    # wire format priced by M_s ("packed" = fixed-length code, arbitrary s;
    # "f32"/"int8"/"int4"/"rs_ag"/"elias" = the runtime's aggregation
    # transports — "elias" prices the paper's tighter Elias-coded bound,
    # min(worst-case, QSGD-Thm-3.2 expected), unbounded in s).
    wire: str = "packed"
    # codec preconditioner kind priced by M_s / q_s: "qsgd" (the paper's
    # quantizer) or "rotated" (randomized-Hadamard preconditioning —
    # GQFedWAvg's family; pow2-padded levels + 32-bit seed on the wire).
    # Scenario derives this from the algorithm family so the optimizer
    # provably prices the codec the runtime runs.
    codec_kind: str = "qsgd"
    # per-worker availability a_n in (0, 1]: the probability an attempted
    # update is usable (crash / corruption survival).  Inflates the
    # convergence variance blocks exactly like client sampling with
    # pi_n -> a_n pi_n.  None = the historical always-available arithmetic.
    # Scenario stamps this from the fault model (repro.faults).
    an: Optional[np.ndarray] = None
    # worst-case uncertainty margins: the time constraint prices
    # F_n (1 - freq_margin) and r_n (1 - rate_margin) — worst case over
    # the capability box (still posynomial: T is monotone in F_n, r_n).
    freq_margin: float = 0.0
    rate_margin: float = 0.0

    def __post_init__(self):
        for name in ("Fn", "Cn", "pn", "rn", "alphan"):
            object.__setattr__(self, name, np.asarray(getattr(self, name), dtype=np.float64))
        n = self.Fn.shape[0]
        assert all(getattr(self, k).shape == (n,) for k in ("Cn", "pn", "rn", "alphan"))
        assert len(self.sn) == n
        if self.an is not None:
            object.__setattr__(self, "an", np.asarray(self.an, np.float64))
            assert self.an.shape == (n,)
            assert np.all((self.an > 0.0) & (self.an <= 1.0)), self.an
        assert 0.0 <= self.freq_margin < 1.0, self.freq_margin
        assert 0.0 <= self.rate_margin < 1.0, self.rate_margin

    @property
    def N(self) -> int:
        return int(self.Fn.shape[0])

    # --- quantization-derived quantities (delegated to repro.compress so
    # the optimizer provably prices the same bytes the runtime sends).
    # All derived quantities are memoized (functools.cached_property writes
    # straight into __dict__, which frozen dataclasses permit): the GIA inner
    # loop reads q_pairs / comm_time on every surrogate build, and rebuilding
    # codec objects there is pure overhead.
    def codec(self, s: Optional[int]):
        return make_codec(s, wire=self.wire, bucket=self.q_dim,
                          kind=self.codec_kind)

    @functools.cached_property
    def M_s0(self) -> float:
        return self.codec(self.s0).wire_bits(self.dim)

    @functools.cached_property
    def M_sn(self) -> np.ndarray:
        return np.array([self.codec(s).wire_bits(self.dim) for s in self.sn])

    @functools.cached_property
    def q_s0(self) -> float:
        return self.codec(self.s0).variance_bound(self.dim)

    @functools.cached_property
    def q_sn(self) -> np.ndarray:
        return np.array([self.codec(s).variance_bound(self.dim)
                         for s in self.sn])

    @functools.cached_property
    def q_pairs(self) -> np.ndarray:
        """q_{s0,sn} per worker (Theorem 1)."""
        return np.array([q_pair(self.q_s0, q) for q in self.q_sn])

    # --- per-global-iteration cost pieces -------------------------------
    @functools.cached_property
    def comp_time_coeff(self) -> np.ndarray:
        """C_n / F_n — per-sample-per-local-iteration compute time."""
        return self.Cn / self.Fn

    @functools.cached_property
    def comm_time(self) -> float:
        """max_n M_{s_n}/r_n + M_{s_0}/r_0 + C_0/F_0 (the K/B-independent part)."""
        return float(np.max(self.M_sn / self.rn) + self.M_s0 / self.r0
                     + self.C0 / self.F0)

    @functools.cached_property
    def comp_time_coeff_wc(self) -> np.ndarray:
        """Worst-case ``C_n / (F_n (1 - freq_margin))``.  At zero margin
        this IS ``comp_time_coeff`` (same object — zero-margin problems
        stay bitwise identical to the historical arithmetic)."""
        if self.freq_margin == 0.0:
            return self.comp_time_coeff
        return self.Cn / (self.Fn * (1.0 - self.freq_margin))

    @functools.cached_property
    def comm_time_wc(self) -> float:
        """Worst-case ``comm_time`` with worker uplink rates derated by
        ``rate_margin`` (server multicast/compute terms stay nominal —
        the uncertainty box covers worker capabilities)."""
        if self.rate_margin == 0.0:
            return self.comm_time
        return float(np.max(self.M_sn / (self.rn * (1.0 - self.rate_margin)))
                     + self.M_s0 / self.r0 + self.C0 / self.F0)

    @functools.cached_property
    def comp_energy_coeff(self) -> np.ndarray:
        """alpha_n C_n F_n^2 — per-sample-per-local-iteration compute energy."""
        return self.alphan * self.Cn * self.Fn**2

    @functools.cached_property
    def const_energy(self) -> float:
        """alpha_0 C_0 F_0^2 + sum_{n in N̄} p_n M_{s_n}/r_n."""
        return float(self.alpha0 * self.C0 * self.F0**2
                     + self.p0 * self.M_s0 / self.r0
                     + np.sum(self.pn * self.M_sn / self.rn))

    @functools.cached_property
    def server_energy(self) -> float:
        """The worker-independent slice of ``const_energy`` — server
        compute + multicast (paid every round regardless of the cohort)."""
        return float(self.alpha0 * self.C0 * self.F0**2
                     + self.p0 * self.M_s0 / self.r0)

    @functools.cached_property
    def comm_energy_coeff(self) -> np.ndarray:
        """p_n M_{s_n} / r_n — per-worker upload energy per round (paid by
        a worker only in rounds it participates)."""
        return self.pn * self.M_sn / self.rn

    def resized(self, N: int) -> "EdgeSystem":
        """This system with ``N`` workers: per-worker arrays tiled (or
        truncated) cyclically, server parameters untouched — the knob
        ``Scenario.sweep(over={"N": ...})`` turns."""
        N = int(N)
        reps = -(-N // self.N)             # ceil(N / current N)
        return dataclasses.replace(
            self,
            Fn=np.tile(self.Fn, reps)[:N], Cn=np.tile(self.Cn, reps)[:N],
            pn=np.tile(self.pn, reps)[:N], rn=np.tile(self.rn, reps)[:N],
            sn=(list(self.sn) * reps)[:N],
            alphan=np.tile(self.alphan, reps)[:N],
            an=None if self.an is None else np.tile(self.an, reps)[:N])

    # --- canonical instantiations ---------------------------------------
    @staticmethod
    def paper_sec_vii(dim: int = 784 * 128 + 128 + 128 * 10 + 10,
                      F_ratio: float = 10.0, s_ratio: float = 1.0,
                      s0: int = 2**14, N: int = 10) -> "EdgeSystem":
        """The exact Sec.-VII system: two worker classes of 5 workers each.

        F^(1)+F^(2) = 2e9 with F^(1)/F^(2) = F_ratio;
        s^(1)+s^(2) = 2*2^14 with s^(1)/s^(2) = s_ratio.
        """
        assert N % 2 == 0
        F2 = 2e9 / (1.0 + F_ratio)
        F1 = F_ratio * F2
        sbar = 2.0**14
        s2 = 2 * sbar / (1.0 + s_ratio)
        s1 = s_ratio * s2
        half = N // 2
        Fn = np.array([F1] * half + [F2] * half)
        sn = [max(1, int(round(s1)))] * half + [max(1, int(round(s2)))] * half
        return EdgeSystem(
            F0=3e9, C0=100.0, p0=20.0, r0=7.5e7, s0=s0, alpha0=2e-28,
            Fn=Fn, Cn=np.full(N, 1e8), pn=np.full(N, 1.5),
            rn=np.full(N, 1e6), sn=sn, alphan=np.full(N, 2e-28), dim=dim)

    @staticmethod
    def h100_fleet(dim: int, n_groups: int, chips_per_group: int,
                   s0: Optional[int] = 2**7, sn: Optional[int] = 2**7,
                   link_bw: float = 400e9, peak_flops: float = 989e12,
                   watts_per_chip: float = 700.0,
                   flops_per_sample_step: float = 1.0) -> "EdgeSystem":
        """Re-parameterize the cost models with H100 fleet constants
        (``repro``'s ``tpu_v5e_fleet`` arithmetic): dense bf16 989 TFLOP/s
        a card (NVIDIA's H100 SXM5 data sheet) at an assumed 40 % MFU,
        700 W a card (the card's power limit), one 400 Gb/s NDR InfiniBand
        adapter a card between groups (``link_bw`` in bits/s).

        Each FL "worker" is a replica group of ``chips_per_group`` cards;
        the "server" is the reduction over the slow inter-group links.
        ``C_n`` is expressed in FLOPs (so ``F_n`` is FLOP/s) — the ratio
        C/F is all that matters to the model.
        """
        N = n_groups
        group_flops = peak_flops * chips_per_group * 0.4  # 40% MFU assumption
        watts = watts_per_chip * chips_per_group
        return EdgeSystem(
            F0=group_flops, C0=float(2 * dim), p0=watts,
            r0=link_bw, s0=s0,
            alpha0=watts / group_flops**3,
            Fn=np.full(N, group_flops),
            Cn=np.full(N, flops_per_sample_step),
            pn=np.full(N, watts),
            rn=np.full(N, link_bw),
            sn=[sn] * N,
            alphan=np.full(N, watts / group_flops**3),
            dim=dim, q_dim=4096)


def time_cost(sys: EdgeSystem, K0, Kn, B, worst_case: bool = False):
    """T(K, B) — eq. (17).  Broadcasts over an ndarray ``K0``.

    ``worst_case=True`` prices the derated worker capabilities
    ``F_n (1 - freq_margin)`` / ``r_n (1 - rate_margin)`` — identical to
    the nominal arithmetic when the system carries zero margins.
    """
    Kn = np.asarray(Kn, dtype=np.float64)
    ct = sys.comp_time_coeff_wc if worst_case else sys.comp_time_coeff
    tau = sys.comm_time_wc if worst_case else sys.comm_time
    out = K0 * (B * np.max(ct * Kn) + tau)
    return out if np.ndim(K0) else float(out)


def energy_cost(sys: EdgeSystem, K0, Kn, B, pi=None):
    """E(K, B) — eq. (18).  Broadcasts over an ndarray ``K0``.

    ``pi`` (per-worker inclusion probabilities under client sampling)
    turns this into the *expected* energy over cohort draws: each worker's
    compute and upload terms scale by ``pi_n``.  ``pi=None`` is the
    historical full-participation arithmetic, verbatim.
    """
    Kn = np.asarray(Kn, dtype=np.float64)
    if pi is None:
        out = K0 * (B * np.sum(sys.comp_energy_coeff * Kn)
                    + sys.const_energy)
    else:
        pi = np.asarray(pi, dtype=np.float64)
        out = K0 * (B * np.sum(sys.comp_energy_coeff * pi * Kn)
                    + sys.server_energy
                    + np.sum(sys.comm_energy_coeff * pi))
    return out if np.ndim(K0) else float(out)
