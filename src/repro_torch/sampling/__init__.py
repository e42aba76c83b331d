"""repro_torch.sampling: client sampling / partial participation.

Only the neutral model ("full") is ported so far; uniform and importance
cohorts, with their runtime hooks, are ROADMAP Queue 1, item 6.

Pluggable participation models (mirroring :mod:`repro.families`): each
model contributes GP decision variables + expected-cost / inflated
convergence-bound coefficients to the optimizer, and a seeded cohort draw
+ unbiased Horvitz-Thompson reweighting to the runtimes.

"""
from .base import (SamplingModel, check_probs, cohort_weights, draw_cohort,
                   draw_cohort_weights, widen_varmap)
from .builtin import FullParticipation
from .registry import get_sampling, register, resolve, sampling_names

__all__ = [
    "SamplingModel", "FullParticipation",
    "register", "get_sampling", "sampling_names", "resolve",
    "draw_cohort", "cohort_weights", "draw_cohort_weights",
    "widen_varmap", "check_probs",
]

#: the named models: "full" (the neutral default)
BUILTIN_SAMPLING = (FullParticipation(),)
for _s in BUILTIN_SAMPLING:
    register(_s, overwrite=True)
del _s
