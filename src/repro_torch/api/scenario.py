"""Scenario: the declarative front door of the optimization framework.

One object bundles everything the paper's closed loop needs — the edge
system (cost model), the ML-problem constants, the budgets ``(T_max,
C_max)``, the step-size rule, and the algorithm family — and exposes the
loop as two calls:

    plan   = scenario.optimize()          # GIA/CGP -> frozen Plan
    report = scenario.run(plan, task)     # train -> RunReport vs predictions

plus the batched third call: ``scenario.sweep(over={...})`` expands a
budget / rule grid, solves it through the batched GIA engine (one captured
step program per structure group on the card), and returns a
:class:`~repro_torch.api.sweep.SweepReport` with tidy rows and Pareto-front
extraction.

The port carries every algorithm family (``genqsgd``, ``pm``, ``fa``,
``pr``, ``gqfedwavg`` and registered variants), every participation model
(``full``, ``uniform``, ``importance``) and fault model (``none``,
``edge``), the scalar NumPy solver, the batched (``"torch"``) and fused
(``"torch-fused"``) device solvers, plan serving
(``optimize(server=...)``, :class:`~repro_torch.serve.PlanServer`) and the
reference runtime and the federated LM runtime (``backend="spmd"`` on an
:class:`~repro_torch.api.tasks.SpmdTask`), and writes the drift ledger of
each run when :mod:`repro_torch.obs` is on, on a system with or without
per-bucket norms (``q_dim``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Union

import numpy as np
import torch

from .. import obs as _obs, same_device
from ..core.cost import EdgeSystem, energy_cost, time_cost
from ..core.convergence import MLProblemConstants
from ..core.genqsgd import GenQSGD, flatten_like
from ..core.step_rules import (ConstantRule, DiminishingRule, ExponentialRule,
                               StepRule)
from ..families import AlgorithmFamily, resolve
from ..opt.gia import solve_param_opt, solve_param_opt_batched
from ..opt.problems import Objective, ParamOptProblem, VarMap
from .plan import Plan, RunReport
from .tasks import MNISTTask

__all__ = ["Scenario"]

_RULE_FOR = {Objective.CONSTANT: ConstantRule,
             Objective.EXPONENTIAL: ExponentialRule,
             Objective.DIMINISHING: DiminishingRule}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A federated-edge-learning scenario: system + problem + budgets +
    algorithm.  Frozen; derive variants with ``dataclasses.replace``."""

    system: EdgeSystem
    consts: MLProblemConstants
    T_max: float                          # time budget (s), constraint (20)
    C_max: float                          # convergence-error budget, (21)
    family: Union[str, AlgorithmFamily] = "genqsgd"  # repro.families key
    step: Optional[StepRule] = None       # None -> jointly optimized (m=J)
    samples_per_worker: float = 6000.0    # I_n (FedAvg's epoch tie)
    sampling: object = "full"             # repro.sampling key or model
    faults: object = "none"               # repro.faults key or model

    def __post_init__(self):
        resolve(self.family)              # unknown names fail here, loudly
        self.sampling_obj.validate(self.system.N)
        self.faults_obj.validate(self.system.N)
        if self.consts.N != self.system.N:
            raise ValueError(
                f"consts describe N={self.consts.N} workers but the system "
                f"has N={self.system.N}")

    # ------------------------------------------------------------------
    @property
    def family_obj(self) -> AlgorithmFamily:
        """The resolved :class:`~repro.families.AlgorithmFamily`."""
        return resolve(self.family)

    @property
    def sampling_obj(self):
        """The resolved :class:`~repro.sampling.SamplingModel`."""
        from ..sampling import resolve as resolve_sampling
        return resolve_sampling(self.sampling)

    @property
    def faults_obj(self):
        """The resolved :class:`~repro.faults.FaultModel`."""
        from ..faults import resolve as resolve_faults
        return resolve_faults(self.faults)

    @property
    def family_key(self) -> str:
        return self.family_obj.key

    @functools.cached_property
    def _priced_system(self) -> EdgeSystem:
        """The system whose M_s / q_s price the *family's* codec — the one
        guarantee of the closed loop: the optimizer and the runtime move
        the same bytes through the same quantizer.  A rotated family on a
        bucketed system drops ``q_dim``: rotation isotropizes the whole
        message, so per-bucket norms are redundant (and the codec rejects
        the combination).  A non-neutral fault model additionally stamps
        its availability / worst-case margins, so the GP plans for the
        fleet the runtime will actually face — neutral fault models leave
        the system object untouched (bitwise)."""
        fam = self.family_obj
        sys = self.system
        fm = self.faults_obj
        if not fm.is_neutral(sys.N):
            an = fm.availability(sys.N) if sys.an is None else sys.an
            fmg = max(float(sys.freq_margin), float(fm.freq_margin))
            rmg = max(float(sys.rate_margin), float(fm.rate_margin))
            if an is not None or fmg != sys.freq_margin \
                    or rmg != sys.rate_margin:
                sys = dataclasses.replace(sys, an=an, freq_margin=fmg,
                                          rate_margin=rmg)
        if fam.codec_kind == sys.codec_kind:
            return sys
        q_dim = None if fam.codec_kind == "rotated" else sys.q_dim
        return dataclasses.replace(sys, codec_kind=fam.codec_kind,
                                   q_dim=q_dim)

    # ------------------------------------------------------------------
    @property
    def objective(self) -> Objective:
        """The convergence-error measure m implied by the step rule."""
        if self.step is None:
            return Objective.JOINT
        return Objective.coerce(self.step.name, _warn=False)

    def _resolve(self, m) -> Objective:
        m = self.objective if m is None else Objective.coerce(m, _warn=False)
        if m is Objective.JOINT:
            if self.step is not None:
                raise ValueError(
                    f"m=J jointly optimizes the step size; this Scenario "
                    f"pins step={self.step!r} — drop it or pick its m")
        else:
            want = _RULE_FOR[m]
            if not isinstance(self.step, want):
                raise ValueError(
                    f"objective {m.name} needs step={want.__name__}, "
                    f"got {type(self.step).__name__ if self.step else None}")
        return m

    def problem(self, m=None, vmap: Optional[VarMap] = None) -> ParamOptProblem:
        """The underlying :class:`ParamOptProblem` (escape hatch for direct
        ``evaluate``/``feasible`` queries and fixed-parameter baselines)."""
        m = self._resolve(m)
        fam = self.family_obj
        if vmap is None:
            vmap = fam.make_varmap(
                self.system.N,
                m in (Objective.EXPONENTIAL, Objective.JOINT),
                self.samples_per_worker)
        gamma = None if self.step is None else float(self.step.gamma)
        rho = getattr(self.step, "rho", None)
        return ParamOptProblem(sys=self._priced_system, consts=self.consts,
                               T_max=self.T_max, C_max=self.C_max, m=m,
                               gamma=gamma, rho=rho, vmap=vmap, family=fam,
                               sampling=self.sampling_obj,
                               faults=self.faults_obj)

    # ------------------------------------------------------------------
    def _plan_from_result(self, m: Objective, r) -> Plan:
        """Freeze a :class:`~repro.opt.gia.GIAResult` into a Plan."""
        if m is Objective.JOINT:
            step = ConstantRule(float(r.gamma))
        else:
            step = self.step
        sys = self._priced_system
        fam = self.family_obj
        samp = self.sampling_obj
        if samp.free_S:                   # integer-recovered cohort size
            cohort_S = None if r.S is None else int(r.S)
        else:
            cohort_S = samp.pinned_S(sys.N)   # None for full / neutral
        sampling_p = samp.plan_p(sys.N) if cohort_S is not None else None
        fault_spec = self._fault_spec(tuple(int(k) for k in r.Kn), int(r.B))
        return Plan(K0=int(r.K0), Kn=tuple(int(k) for k in r.Kn), B=int(r.B),
                    step_rule=step, s0=sys.s0, sn=tuple(sys.sn), dim=sys.dim,
                    q_dim=sys.q_dim, wire=sys.wire, objective=m,
                    family=fam.key, codec_kind=fam.codec_kind,
                    agg_weights=fam.agg_weights(sys.N),
                    momentum=fam.momentum, normalize=fam.normalize,
                    sampling=samp.key if cohort_S is not None else "full",
                    cohort_S=cohort_S, sampling_p=sampling_p,
                    faults=fault_spec,
                    predicted_E=r.E, predicted_T=r.T,
                    predicted_C=r.C, feasible=bool(r.feasible),
                    converged=bool(r.converged))

    def _fault_spec(self, Kn, B):
        """The frozen per-plan fault contract (None when the fault model
        has no runtime behavior): nominal per-worker round times from the
        cost model, deadline ``tau = slack x predicted round time``, and
        the exact delivery probabilities the HT reweighting divides by."""
        fm = self.faults_obj
        sys = self._priced_system
        if not fm.runtime_active(sys.N):
            return None
        from ..faults import FaultSpec
        Kn = np.asarray(Kn, np.float64)
        # worker n's nominal time in one round: compute + its own upload
        wt = B * sys.comp_time_coeff * Kn + sys.M_sn / sys.rn
        # the Plan's predicted round time (eq. 17's per-round bracket)
        round_t = B * float(np.max(sys.comp_time_coeff * Kn)) + sys.comm_time
        deadline = float(fm.deadline_slack) * round_t
        dp = fm.deliver_prob(wt, deadline)
        return FaultSpec(model=fm, worker_times=tuple(float(t) for t in wt),
                         deadline=deadline,
                         deliver_p=tuple(float(p) for p in dp))

    def optimize(self, m=None, z0=None, tol: float = 1e-4,
                 max_iter: int = 60, verbose: bool = False,
                 backend: str = "numpy", server=None,
                 device="cuda") -> Plan:
        """Solve the scenario's parameter-optimization problem (Algorithms
        2-5) and freeze the solution into a :class:`Plan`.

        ``backend`` picks the solver engine: ``"numpy"`` (the scalar
        reference loop, on the host; ``device`` is not read) or
        ``"torch"``/``"torch-fused"`` on ``device`` — the fused engine
        captures one step program per structure signature into a
        process-level cache, so repeated ``optimize()`` calls across
        distinct Scenario objects reuse it.  ``"jnp"``/``"jnp-fused"``
        raise ``ValueError`` naming these counterparts.  ``z0`` warm-starts
        the GIA (e.g. from a previously solved neighbor's ``Plan``).
        Passing ``server`` (a :class:`~repro_torch.serve.PlanServer`)
        routes the request through its micro-batching queue and warm-start
        cache instead — the server's own ``tol``/``max_iter``/``device``
        (and backend) govern, and concurrent same-signature requests share
        one fused dispatch."""
        if server is not None:
            return server.solve(self, m=m)
        m = self._resolve(m)
        with _obs.trace.span("scenario.optimize", m=str(m.value),
                             family=str(self.family), backend=backend):
            prob = self.problem(m)
            if backend == "numpy":
                r = solve_param_opt(prob, z0=z0, tol=tol, max_iter=max_iter,
                                    verbose=verbose)
            else:
                r = solve_param_opt_batched(
                    [prob], z0s=None if z0 is None else [z0], tol=tol,
                    max_iter=max_iter, backend=backend, verbose=verbose,
                    device=device)[0]
            return self._plan_from_result(m, r)

    def sweep(self, over, names=None, backend: str = "auto",
              tol: float = 1e-4, max_iter: int = 60, parallel: bool = True,
              device="cuda"):
        """Expand ``over`` (field name -> iterable of values; ``rule`` /
        ``cmax`` / ``tmax`` aliases accepted) into Scenario variants, solve
        them all through the batched engine on ``device`` (``"auto"`` is
        the fused engine), and return a
        :class:`~repro_torch.api.sweep.SweepReport` (tidy rows,
        ``pareto_front()``, ``to_csv``)."""
        from .sweep import expand_grid, sweep_scenarios
        scenarios = expand_grid(self, over)
        return sweep_scenarios(scenarios, names=names, backend=backend,
                               tol=tol, max_iter=max_iter, parallel=parallel,
                               device=device)

    # ------------------------------------------------------------------
    def run(self, plan: Plan, task=None, backend: str = "reference",
            seed: int = 0, max_rounds: Optional[int] = None,
            eval_every: int = 0, wire: str = "f32", log_every: int = 0,
            device="cuda") -> RunReport:
        """Execute training with exactly the Plan's parameters.

        backend="reference" runs Algorithm 1 single-process on a reference
        task (default: the Sec.-VII MNIST-like task on ``device``);
        backend="spmd" runs the federated LM runtime on an
        :class:`~repro_torch.api.tasks.SpmdTask`, moving the Plan's
        quantized levels over the ``wire`` transport.  A given task must
        live on ``device``.
        """
        with _obs.trace.span("scenario.run", backend=backend,
                             family=plan.family, rounds=plan.K0):
            if backend == "reference":
                report = self._run_reference(plan, task, seed, max_rounds,
                                             eval_every, device)
            elif backend == "spmd":
                report = self._run_spmd(plan, task, seed, max_rounds, wire,
                                        log_every, device)
            else:
                raise ValueError(f"unknown backend {backend!r}; "
                                 f"expected 'reference' or 'spmd'")
        if _obs.enabled():
            # the drift ledger artifact: a pure function of the report (the
            # report itself is identical with obs off; only this file write
            # is added)
            report.drift().to_jsonl(_obs.artifact_path(
                f"ledger_{plan.family}_{backend}_seed{seed}.jsonl"))
        return report

    def _report(self, plan: Plan, backend: str, rounds: int, model_dim: int,
                wall: float, final_metrics: dict, history,
                wire: Optional[str] = None, cohort_trace=None,
                fault_trace=None) -> RunReport:
        # wire=None prices at the Plan's wire (the reference backend has no
        # transport); the spmd path passes the transport it actually used.
        # Cost-model measurements evaluate on the *priced* system — the one
        # whose M_s/q_s describe the family's codec — so measured_E/T are
        # comparable to predicted_E/T within the same report.
        if cohort_trace:
            # sampled run: realized per-round cohort uploads, summed; the
            # modeled energy is the expected energy at the Plan's pi_n —
            # the same energy_cost(pi=...) the optimizer minimized.
            trace = tuple(plan.cohort_round_bits(idx, dim=model_dim,
                                                 wire=wire)
                          for idx in cohort_trace)
            comm = float(sum(trace))
        else:
            trace = ()
            comm = rounds * plan.round_bits(dim=model_dim, wire=wire)
        pi = None
        if plan.cohort_S is not None:
            pi = (np.full(plan.N, float(plan.cohort_S) / plan.N)
                  if plan.sampling_p is None
                  else float(plan.cohort_S) * np.asarray(plan.sampling_p))
        sys = self._priced_system
        Kn = np.asarray(plan.Kn)
        return RunReport(
            plan=plan, backend=backend, rounds=rounds,
            model_dim=model_dim, wall_time_s=wall, comm_bits=comm,
            measured_E=energy_cost(sys, rounds, Kn, plan.B, pi=pi),
            measured_T=time_cost(sys, rounds, Kn, plan.B),
            final_metrics=dict(final_metrics), history=tuple(history),
            round_bits_trace=trace, fault_trace=fault_trace)

    def _run_reference(self, plan, task, seed, max_rounds, eval_every,
                       device):
        task = MNISTTask(device=device) if task is None else task
        if not same_device(task.device, device):
            raise ValueError(f"task lives on {task.device}, the run was asked "
                             f"for device={device!r}")
        cfg = plan.to_genqsgd_config(max_K0=max_rounds, seed=seed)
        alg = GenQSGD(task.loss, task.make_data(plan.N), task.shapes, cfg)
        gen = torch.Generator(device=task.device)
        x0 = flatten_like(task.init_params(gen.manual_seed(seed)))
        eval_fn = task.metrics if eval_every else None
        t0 = time.time()
        xf, hist = alg.run(x0, gen.manual_seed(seed + 1), eval_fn=eval_fn,
                           eval_every=eval_every or max(1, cfg.K0))
        if xf.is_cuda:                    # the launches are asynchronous
            torch.cuda.synchronize(xf.device)
        wall = time.time() - t0
        final = task.metrics(xf)
        return self._report(plan, "reference", cfg.K0, alg.dim, wall, final,
                            hist, cohort_trace=alg.cohort_trace,
                            fault_trace=alg.fault_trace)

    def _run_spmd(self, plan, task, seed, max_rounds, wire, log_every,
                  device):
        from ..fed.runtime import tree_leaves
        from ..train.trainer import GenQSGDTrainer
        from .tasks import SpmdTask

        if not isinstance(task, SpmdTask):
            raise ValueError("backend='spmd' needs an SpmdTask (model api, "
                             "arch config, batches, transport, device)")
        if not same_device(task.device, device):
            raise ValueError(f"task lives on {task.device}, the run was asked "
                             f"for device={device!r}")
        fed = plan.to_fed_config(wire=wire, seed=seed)
        trainer = GenQSGDTrainer(task.api, task.arch, fed, task.transport,
                                 step_rule=plan.step_rule,
                                 checkpoint_dir=task.checkpoint_dir,
                                 device=task.device)
        state = trainer.init(seed)
        model_dim = sum(int(l.numel()) for l in tree_leaves(state.params))
        rounds = plan.K0 if max_rounds is None else min(plan.K0, max_rounds)
        t0 = time.time()
        state = trainer.run(state, task.batches, seed + 1, n_rounds=rounds,
                            log_every=log_every or max(1, rounds // 10),
                            eval_fn=task.eval_fn)
        if trainer.device.type == "cuda":  # the launches are asynchronous
            torch.cuda.synchronize(trainer.device)
        wall = time.time() - t0
        final = dict(state.history[-1]) if state.history else {}
        return self._report(plan, "spmd", rounds, model_dim, wall, final,
                            state.history, wire=wire,
                            cohort_trace=trainer.cohort_trace,
                            fault_trace=trainer.fault_trace)
