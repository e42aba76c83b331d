"""repro_torch.families — pluggable FL-algorithm-family subsystem.

An :class:`AlgorithmFamily` owns everything the pipeline used to hardcode
for GenQSGD: the decision-variable map, the convergence-block reweighting
hooks the batched/fused GIA consumes, the runtime aggregation / local-update
hooks, and the codec preconditioner kind.  See :mod:`repro.families.base`
for the interface and :mod:`repro.families.builtin` for the shipped
families (``genqsgd`` / ``pm`` / ``fa`` / ``pr`` bit-identical to the
pre-family pipeline, plus ``gqfedwavg``).

    from repro_torch.families import get_family, register
    fam = get_family("gqfedwavg")
    register(GQFedWAvgFamily(key="gqfedwavg-heavy", momentum=0.9))
"""
from .base import AlgorithmFamily, check_agg_weights, check_momentum
from .builtin import BUILTIN_FAMILIES, GenQSGDFamily, GQFedWAvgFamily
from .registry import family_names, get_family, register, resolve

__all__ = [
    "AlgorithmFamily", "GenQSGDFamily", "GQFedWAvgFamily",
    "register", "get_family", "family_names", "resolve",
    "BUILTIN_FAMILIES", "check_agg_weights", "check_momentum",
]

for _fam in BUILTIN_FAMILIES:
    register(_fam, overwrite=True)
del _fam
