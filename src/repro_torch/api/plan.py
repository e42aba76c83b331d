"""Plan and RunReport: the two value objects of the optimize→train loop.

A :class:`Plan` is the frozen output of ``Scenario.optimize`` — the single
source of truth for the paper's decision variables ``(K0, Kn, B, Γ)`` plus
the quantizer parameters ``(s0, sn, q_dim, wire)`` they were optimized
against.  The runtime configuration
(:class:`~repro_torch.core.genqsgd.GenQSGDConfig`) derives from it, so the
parameters can never disagree between the optimizer and the training run.
The fields are the JAX package's, so the two packages' Plans compare field
for field; ``to_fed_config`` gives the federated LM runtime's
:class:`~repro_torch.fed.FedConfig`, refusing quantizers its wire cannot
carry.

A :class:`RunReport` closes the loop: it compares what a training run
actually moved/cost (communication bits through the
``codec.wire_bits`` accounting, cost-model energy/time at
the executed round count, wall-clock) against the Plan's predictions, and
``RunReport.drift()`` refines that into a per-round drift ledger
(:class:`~repro_torch.obs.ledger.RunLedger`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..compress import RUNTIME_WIRES, elias, make_codec, wire_max_s
from ..core.genqsgd import GenQSGDConfig
from ..core.step_rules import StepRule
from ..opt.problems import Objective

__all__ = ["Plan", "RunReport"]


@dataclasses.dataclass(frozen=True)
class Plan:
    """Frozen, validated parameterization of one GenQSGD training job.

    Produced by ``Scenario.optimize`` (predictions filled in from the GIA
    solution) or hand-built via :meth:`manual` for runs that skip the
    optimizer but still want one source of truth for their configs.
    """

    K0: int                              # global iterations
    Kn: Tuple[int, ...]                  # per-worker local iterations
    B: int                               # mini-batch size
    step_rule: StepRule                  # Γ (optimized gamma for m=J)
    s0: Optional[int] = None             # server quantizer
    sn: Tuple[Optional[int], ...] = ()   # per-worker quantizers (len N)
    dim: int = 0                         # model dimension priced by M_s
    q_dim: Optional[int] = None          # per-bucket-norm size (None = whole)
    wire: str = "packed"                 # pricing wire format (EdgeSystem's)
    objective: Objective = Objective.CONSTANT
    family: str = "genqsgd"
    # family runtime hooks (repro_torch.families), frozen into the Plan so both
    # runtime configs derive the same aggregation/local-update/codec rules
    codec_kind: str = "qsgd"             # make_codec preconditioner kind
    agg_weights: Optional[Tuple[float, ...]] = None  # w_n (None = mean)
    momentum: float = 0.0                # local-update momentum beta
    normalize: bool = False              # normalized local updates
    # client sampling (repro_torch.sampling), frozen into the Plan so both
    # runtimes draw the cohorts the optimizer priced
    sampling: str = "full"               # participation-model key
    cohort_S: Optional[int] = None       # per-round cohort size (None = full)
    sampling_p: Optional[Tuple[float, ...]] = None  # base probs (None = unif)
    # fault injection (repro_torch.faults), frozen into the Plan so both runtimes
    # draw the faults — and divide by the delivery probabilities — the
    # optimizer planned for.  A FaultSpec (model + per-worker nominal round
    # times + deadline tau + delivery probabilities); None = fault-free.
    faults: Optional[object] = None
    # predictions at (K0, Kn, B) — NaN for manual plans
    predicted_E: float = float("nan")    # energy (J), eq. (18)
    predicted_T: float = float("nan")    # time (s), eq. (17)
    predicted_C: float = float("nan")    # convergence error bound
    feasible: bool = True
    converged: bool = True

    def __post_init__(self):
        object.__setattr__(self, "Kn", tuple(int(k) for k in self.Kn))
        # default: exact communication (s = infinity) for every worker
        object.__setattr__(self, "sn", tuple(self.sn) if self.sn
                           else (None,) * len(self.Kn))
        object.__setattr__(self, "objective",
                           Objective.coerce(self.objective, _warn=False))
        if self.K0 < 1 or self.B < 1 or any(k < 1 for k in self.Kn):
            raise ValueError(f"K0, Kn, B must be >= 1, got "
                             f"K0={self.K0} Kn={self.Kn} B={self.B}")
        if len(self.sn) != len(self.Kn):
            raise ValueError(f"sn has {len(self.sn)} entries for "
                             f"{len(self.Kn)} workers")
        if self.agg_weights is not None:
            from ..families import check_agg_weights
            object.__setattr__(self, "agg_weights",
                               check_agg_weights(self.agg_weights,
                                                 len(self.Kn)))
        if self.codec_kind == "rotated" and self.q_dim is not None:
            raise ValueError(
                "rotation preconditioning and per-bucket norms are mutually "
                "exclusive (the rotation already isotropizes the message); "
                "a rotated Plan must carry q_dim=None")
        if self.sampling_p is not None and self.cohort_S is None:
            raise ValueError("sampling_p given without cohort_S")
        if self.cohort_S is not None:
            from ..sampling.base import check_probs
            S = int(self.cohort_S)
            if not 1 <= S <= self.N:
                raise ValueError(f"cohort_S={S} outside [1, N={self.N}]")
            object.__setattr__(self, "cohort_S", S)
            if self.sampling_p is not None:
                p = check_probs(self.sampling_p, self.N)
                if S * max(p) > 1.0 + 1e-9:
                    raise ValueError(
                        f"inclusion probability S*max(p)={S * max(p):.4g} "
                        f"exceeds 1")
                object.__setattr__(self, "sampling_p", p)
        if self.faults is not None:
            from ..faults import FaultSpec
            if not isinstance(self.faults, FaultSpec):
                raise TypeError(
                    f"Plan.faults must be a repro_torch.faults.FaultSpec (built by "
                    f"Scenario from the fault model + the plan's round "
                    f"times), got {type(self.faults)}")
            if self.faults.N != self.N:
                raise ValueError(
                    f"FaultSpec describes {self.faults.N} workers, plan "
                    f"has {self.N}")

    # ------------------------------------------------------------------
    @classmethod
    def manual(cls, K0: int, Kn, B: int, step_rule: StepRule,
               s0: Optional[int] = None, sn=None, dim: int = 0,
               q_dim: Optional[int] = None, wire: str = "packed",
               family: str = "genqsgd", codec_kind: str = "qsgd",
               agg_weights=None, momentum: float = 0.0,
               normalize: bool = False, faults=None) -> "Plan":
        """A Plan not produced by the optimizer (predictions are NaN)."""
        Kn = tuple(int(k) for k in Kn)
        if isinstance(sn, (int, type(None))):
            sn = (sn,) * len(Kn)
        try:  # custom registered rules default to the constant objective
            obj = Objective.coerce(getattr(step_rule, "name", "C"),
                                   _warn=False)
        except ValueError:
            obj = Objective.CONSTANT
        return cls(K0=int(K0), Kn=Kn, B=int(B), step_rule=step_rule,
                   s0=s0, sn=tuple(sn), dim=int(dim), q_dim=q_dim, wire=wire,
                   objective=obj, family=family, codec_kind=codec_kind,
                   agg_weights=agg_weights, momentum=momentum,
                   normalize=normalize, faults=faults)

    @property
    def N(self) -> int:
        return len(self.Kn)

    @property
    def gamma(self) -> float:
        return float(self.step_rule.gamma)

    @property
    def K_max(self) -> int:
        return int(max(self.Kn))

    # -- bit accounting (the same codec table EdgeSystem.M_s prices) ----
    def round_bits(self, dim: Optional[int] = None,
                   wire: Optional[str] = None) -> float:
        """Wire bits one global iteration moves: N worker uploads plus the
        server multicast, priced by ``codec.wire_bits``."""
        ups, down = self._up_down(dim, wire)
        return sum(ups) + down

    def _up_down(self, dim: Optional[int] = None,
                 wire: Optional[str] = None):
        """Per-worker upload bits + the server multicast bits (client
        sampling needs the per-worker granularity: uploads scale by pi_n,
        the multicast does not)."""
        d = self.dim if dim is None else int(dim)
        w = self.wire if wire is None else wire
        # an explicit wire naming a runtime aggregation transport prices
        # what the federated runtime actually moves: per-tensor QSGD
        # levels — rotation is a whole-model-vector preconditioner the
        # transports cannot carry (to_fed_config).
        # Everything else (wire=None, or a pure pricing format like
        # "packed") uses the Plan's own codec kind, whether passed
        # explicitly or defaulted.
        transport = wire is not None and w in RUNTIME_WIRES
        kind = "qsgd" if transport else self.codec_kind
        ups = [make_codec(s, wire=w, bucket=self.q_dim,
                          kind=kind).wire_bits(d) for s in self.sn]
        # mirror FedConfig.server_codec: an exact multicast (s0=None) is raw
        # f32 regardless of the worker wire (the packing wire can't carry it)
        down_w = "f32" if (self.s0 is None and w == "int4") else w
        down = make_codec(self.s0, wire=down_w, bucket=self.q_dim,
                          kind=kind).wire_bits(d)
        return ups, down

    def expected_round_bits(self, dim: Optional[int] = None,
                            wire: Optional[str] = None) -> float:
        """E[wire bits] of one round under the Plan's participation model:
        each worker's upload scales by its inclusion probability pi_n
        (uniform: ``S * sum_n M_{s_n} / N``), the server multicast by 1.
        Without sampling this IS :meth:`round_bits`, bitwise."""
        if self.cohort_S is None:
            return self.round_bits(dim=dim, wire=wire)
        ups, down = self._up_down(dim, wire)
        S = float(self.cohort_S)
        if self.sampling_p is None:        # uniform: pi_n = S/N for all n
            return S * sum(ups) / self.N + down
        return sum(S * p * u for p, u in zip(self.sampling_p, ups)) + down

    def cohort_round_bits(self, idx, dim: Optional[int] = None,
                          wire: Optional[str] = None) -> float:
        """Realized wire bits of one sampled round: the uploads of the
        cohort ``idx`` actually drawn, plus the server multicast."""
        ups, down = self._up_down(dim, wire)
        return sum(ups[int(i)] for i in idx) + down

    @property
    def predicted_comm_bits(self) -> float:
        """K0 * E[per-round bits] — total bits the cost model budgeted for
        the whole run (the historical N-upload sum without sampling)."""
        return self.K0 * self.expected_round_bits()

    # -- runtime configs (the tentpole: one source of truth) ------------
    def to_genqsgd_config(self, max_K0: Optional[int] = None,
                          seed: Optional[int] = None) -> GenQSGDConfig:
        """The single-process reference runtime's config (Algorithm 1, plus
        the Plan's family hooks: aggregation weights, momentum/normalized
        local updates, codec preconditioner — and, under client sampling,
        the cohort size/probabilities with ``seed`` driving the per-round
        cohort draws)."""
        K0 = self.K0 if max_K0 is None else min(self.K0, int(max_K0))
        return GenQSGDConfig(K0=K0, Kn=self.Kn, B=self.B,
                             step_rule=self.step_rule, s0=self.s0,
                             sn=list(self.sn), bucket=self.q_dim,
                             agg_weights=self.agg_weights,
                             momentum=self.momentum,
                             normalize=self.normalize,
                             codec_kind=self.codec_kind,
                             sampling_S=self.cohort_S,
                             sampling_p=self.sampling_p, seed=seed,
                             faults=self.faults)

    def to_fed_config(self, wire: str = "f32", microbatch: int = 1,
                      aux_weight: float = 0.01,
                      seed: Optional[int] = None):
        """The federated runtime's config, cross-validated against the Plan.

        ``wire`` is the aggregation *transport* (how the quantized levels
        travel); the Plan's ``s0/sn/q_dim`` decide *what* is sent.  Pairs
        the transport cannot carry — e.g. ``wire="int4"`` with s > 7 — are
        rejected here, before any training starts.

        The family's aggregation weights and momentum/normalized local
        updates carry through; the rotation preconditioner does **not** —
        it acts on the whole flattened model vector, while the runtime
        quantizes per tensor, so the transports always move plain QSGD
        levels (the reference backend runs the rotated codec; the
        RunReport's measured comm-bits are priced at the transport actually
        used either way).
        """
        from ..fed.runtime import FedConfig  # lazy: the runtime stack

        if wire not in RUNTIME_WIRES:
            raise ValueError(f"wire must be one of {RUNTIME_WIRES}, "
                             f"got {wire!r}")
        cap = wire_max_s(wire)
        if wire == "elias":
            # elias *pricing* is unbounded in s, but the runtime coder reads
            # levels from an int8 container like the other level transports
            cap = elias.MAX_RUNTIME_S
        for role, s in [("s0", self.s0)] + [(f"sn[{i}]", s)
                                            for i, s in enumerate(self.sn)]:
            if s is not None and cap is not None and s > cap:
                raise ValueError(
                    f"plan {role}={s} cannot ride the {wire!r} transport "
                    f"(carries s <= {cap}); re-optimize the Scenario with "
                    f"quantizers the wire supports or pick a wider wire")
        return FedConfig(n_workers=self.N, Kn=self.Kn, s0=self.s0,
                         sn=self.sn, wire=wire, bucket=self.q_dim,
                         microbatch=microbatch, aux_weight=aux_weight,
                         agg_weights=self.agg_weights,
                         momentum=self.momentum, normalize=self.normalize,
                         sampling_S=self.cohort_S,
                         sampling_p=self.sampling_p, seed=seed,
                         faults=self.faults)

    def describe(self) -> str:
        sn = set(self.sn)
        sn_txt = str(next(iter(sn))) if len(sn) == 1 else str(list(self.sn))
        samp = ("" if self.cohort_S is None
                else f" S={self.cohort_S}/{self.N} ({self.sampling})")
        if self.faults is not None:
            dl = self.faults.deadline
            samp += (f" faults={self.faults.model.key}"
                     f"(tau={'inf' if dl == float('inf') else f'{dl:.3g}s'})")
        return (f"Plan[{self.family}/{self.objective.value}]{samp} "
                f"K0={self.K0} Kn={list(self.Kn)} B={self.B} "
                f"gamma={self.gamma:.4g} s0={self.s0} sn={sn_txt} | "
                f"E={self.predicted_E:.4g} J, T={self.predicted_T:.4g} s, "
                f"C={self.predicted_C:.4g} "
                f"({'feasible' if self.feasible else 'INFEASIBLE'})")


@dataclasses.dataclass(frozen=True)
class RunReport:
    """What a training run measured, next to what its Plan predicted.

    ``comm_bits`` is measured through the same ``codec.wire_bits`` table the
    optimizer priced (executed rounds x per-round message bits at the
    *actual* model dimension); ``measured_E`` / ``measured_T`` evaluate the
    closed-form cost models at the executed round count, while
    ``wall_time_s`` is the real clock.
    """

    plan: Plan
    backend: str                     # "reference" | "spmd"
    rounds: int                      # global iterations actually executed
    model_dim: int                   # flattened dimension of the live model
    wall_time_s: float
    comm_bits: float                 # measured total wire bits
    measured_E: float                # cost-model energy over executed rounds
    measured_T: float                # cost-model time over executed rounds
    final_metrics: dict = dataclasses.field(default_factory=dict)
    history: tuple = ()
    round_bits_trace: tuple = ()     # per-round realized wire bits (sampled
                                     # runs only; empty = uniform K0 rounds)
    fault_trace: Optional[object] = None  # repro_torch.faults.FaultTrace (faulted
                                          # runs only; None = fault-free)

    @property
    def predicted_comm_bits(self) -> float:
        return self.plan.predicted_comm_bits

    @property
    def comm_bits_match(self) -> bool:
        """Exact closure of the loop: did the run move exactly the bits the
        optimizer budgeted?  True when the full K0 executed on a model of
        the dimension the Scenario priced (under client sampling: when the
        realized cohort bits sum to K0 times the expected per-round bits —
        exact for uniform cohorts over homogeneous quantizers)."""
        return self.comm_bits == self.predicted_comm_bits

    def drift(self):
        """The per-round predicted-vs-measured timeline for energy, time
        and comm-bits: a :class:`~repro_torch.obs.ledger.RunLedger` with
        one row per executed round and running cumulative drift ratios.
        A pure function of this frozen report — identical whether
        ``repro_torch.obs`` is enabled or not."""
        from ..obs.ledger import RunLedger
        return RunLedger.from_report(self)

    def summary(self) -> str:
        p = self.plan
        lines = [
            f"RunReport[{self.backend}] {self.rounds}/{p.K0} rounds, "
            f"model dim {self.model_dim} (planned {p.dim}), "
            f"wall {self.wall_time_s:.1f}s",
            f"  comm bits: measured {self.comm_bits:.6g} vs predicted "
            f"{self.predicted_comm_bits:.6g} "
            f"({'EXACT' if self.comm_bits_match else 'differs'})",
            f"  energy:    modeled {self.measured_E:.4g} J vs predicted "
            f"{p.predicted_E:.4g} J",
            f"  time:      modeled {self.measured_T:.4g} s vs predicted "
            f"{p.predicted_T:.4g} s",
        ]
        ft = self.fault_trace
        if ft is not None and len(ft):
            pred_round = p.predicted_T / p.K0
            lines.append(
                f"  faults:    {ft.rounds_degraded}/{len(ft)} rounds "
                f"degraded, {ft.workers_dropped} worker-rounds dropped, "
                f"realized {ft.mean_round_time:.4g} s/round vs predicted "
                f"{pred_round:.4g} s/round")
        if self.final_metrics:
            kv = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in
                          self.final_metrics.items())
            lines.append(f"  metrics:   {kv}")
        return "\n".join(lines)
