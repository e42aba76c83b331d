"""repro_torch.api — the public entry point: Scenario → Plan → Run.

    from repro_torch.api import EdgeSystem, MNISTTask, Scenario

    task = MNISTTask()                    # data on the card
    scenario = Scenario(system=EdgeSystem.paper_sec_vii(dim=task.dim),
                        consts=task.estimate_constants(N=10),
                        T_max=1e5, C_max=0.25)
    plan = scenario.optimize()            # Algorithms 2-5 (NumPy, host)
    report = scenario.run(plan, task=task)  # Algorithm 1 (PyTorch + CUDA)
    print(plan.describe()); print(report.summary())
"""
from ..core.convergence import MLProblemConstants
from ..core.cost import EdgeSystem
from ..core.step_rules import (ConstantRule, DiminishingRule, ExponentialRule,
                               StepRule)
from ..opt.problems import Objective
from .plan import Plan, RunReport
from .scenario import Scenario
from .tasks import MNISTTask

__all__ = [
    "Scenario", "Plan", "RunReport", "EdgeSystem", "MLProblemConstants",
    "MNISTTask", "Objective", "StepRule", "ConstantRule", "ExponentialRule",
    "DiminishingRule",
]
