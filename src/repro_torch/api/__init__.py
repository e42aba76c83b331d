"""repro_torch.api — the public entry point: Scenario → Plan → Run.

    from repro_torch.api import EdgeSystem, MNISTTask, Scenario

    task = MNISTTask()                    # data on the card
    scenario = Scenario(system=EdgeSystem.paper_sec_vii(dim=task.dim),
                        consts=task.estimate_constants(N=10),
                        T_max=1e5, C_max=0.25)
    plan = scenario.optimize()            # Algorithms 2-5 (NumPy, host)
    report = scenario.run(plan, task=task)  # Algorithm 1 (PyTorch + CUDA)
    print(plan.describe()); print(report.summary())

Participation models (``full`` | ``uniform`` | ``importance``) and fault
models (``none`` | ``edge``) plug in as in the JAX package:
``Scenario(sampling=uniform(8), faults=edge_faults(...))`` plans for the
cohort and the fleet's availability, and ``run`` draws seeded cohorts and
faults on the host and aggregates the survivors with unbiased
Horvitz-Thompson weights on the card; ``report.drift()`` is the per-round
drift ledger.  Step rules and the legacy family mapping live in
:mod:`repro_torch.api.registries`.

``scenario.sweep(over={...})`` and :func:`sweep_scenarios` solve whole
grids through the fused GIA on the card (``device="cpu"`` runs the same
step program eagerly on the host); ``scenario.optimize(server=srv)``
routes one request through a :class:`PlanServer` (signature
micro-batching and a warm-start plan cache over the same engine).
``scenario.run(plan, task=SpmdTask(...), backend="spmd", wire=...)``
trains an LM across the Plan's fl workers through the federated runtime
(:class:`GenQSGDTrainer`, :mod:`repro_torch.fed`).
"""
from ..core.convergence import MLProblemConstants
from ..core.cost import EdgeSystem
from ..core.step_rules import (ConstantRule, DiminishingRule, ExponentialRule,
                               StepRule, make_rule)
from ..families import AlgorithmFamily, GQFedWAvgFamily, get_family
from ..faults import FaultModel, FaultTrace, edge_faults
from ..opt.problems import Objective
from ..sampling import SamplingModel, importance, uniform
from .plan import Plan, RunReport
from .registries import (FAMILIES, STEP_RULES, family_names, make_step_rule,
                         make_varmap, register_family, register_step_rule)
from .scenario import Scenario
from .sweep import SweepReport, sweep_scenarios
from .tasks import MNISTTask, QuadraticTask, SpmdTask

__all__ = [
    "Scenario", "Plan", "RunReport", "Objective",
    "SweepReport", "sweep_scenarios",
    "EdgeSystem", "MLProblemConstants",
    "ConstantRule", "ExponentialRule", "DiminishingRule", "StepRule",
    "make_rule", "make_step_rule", "make_varmap",
    "STEP_RULES", "FAMILIES", "register_step_rule", "register_family",
    "family_names", "AlgorithmFamily", "GQFedWAvgFamily", "get_family",
    "SamplingModel", "uniform", "importance",
    "FaultModel", "FaultTrace", "edge_faults",
    "MNISTTask", "QuadraticTask", "SpmdTask",
    "GenQSGDTrainer", "round_comm_bits", "PlanServer",
]


def __getattr__(name):
    # lazy: the trainer pulls the federated runtime stack, which
    # optimizer-only consumers never need; the PlanServer lives in
    # repro_torch.serve (Scenario.optimize(server=...) accepts one)
    if name in ("GenQSGDTrainer", "round_comm_bits"):
        from ..train import trainer
        return getattr(trainer, name)
    if name == "PlanServer":
        from ..serve.planserver import PlanServer
        return PlanServer
    raise AttributeError(f"module 'repro_torch.api' has no attribute "
                         f"{name!r}")
