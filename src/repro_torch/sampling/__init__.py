"""repro_torch.sampling: client sampling / partial participation, end-to-end.

Pluggable participation models (mirroring :mod:`repro_torch.families`):
each model contributes GP decision variables + expected-cost / inflated
convergence-bound coefficients to the optimizer, and a seeded cohort draw
+ unbiased Horvitz-Thompson reweighting to the reference runtime.

    from repro_torch.api import Scenario
    from repro_torch.sampling import uniform

    plan = Scenario(..., sampling="uniform").optimize()   # S chosen by GP
    plan = Scenario(..., sampling=uniform(S=4)).optimize()  # pinned cohort
"""
from .base import (SamplingModel, check_probs, cohort_weights, draw_cohort,
                   draw_cohort_weights, widen_varmap)
from .builtin import (FullParticipation, ImportanceSampling, UniformSampling,
                      importance, uniform)
from .registry import get_sampling, register, resolve, sampling_names

__all__ = [
    "SamplingModel", "FullParticipation", "UniformSampling",
    "ImportanceSampling", "uniform", "importance",
    "register", "get_sampling", "sampling_names", "resolve",
    "draw_cohort", "cohort_weights", "draw_cohort_weights",
    "widen_varmap", "check_probs",
]

#: the named models: "full" (the neutral default) and "uniform" (free S)
BUILTIN_SAMPLING = (FullParticipation(), UniformSampling())
for _s in BUILTIN_SAMPLING:
    register(_s, overwrite=True)
del _s
