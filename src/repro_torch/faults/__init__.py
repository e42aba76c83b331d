"""repro_torch.faults: seeded fault injection + deadline-HT aggregation.

Only the neutral model ("none") is ported so far; the edge-fleet model and
the runtime's fault hooks are ROADMAP Queue 1, item 6.

Pluggable fault models (mirroring :mod:`repro.sampling` /
:mod:`repro.families`): each model contributes availability / worst-case
margin coefficients to the optimizer, and a seeded per-round fault draw
(straggler latency inflation, multi-round crashes, checksum-failing
payload corruption) to both runtimes, aggregated past a per-round
deadline with unbiased Horvitz-Thompson reweighting of the survivors.

"""
from .base import (FaultDriver, FaultModel, FaultSpec, FaultTrace,
                   RoundFaultRecord, RoundFaults, fault_rng, flip_bits,
                   payload_checksum)
from .builtin import NoFaults
from .registry import fault_names, get_faults, register, resolve

__all__ = [
    "FaultModel", "NoFaults",
    "register", "get_faults", "fault_names", "resolve",
    "FaultDriver", "FaultSpec", "FaultTrace", "RoundFaults",
    "RoundFaultRecord", "fault_rng", "payload_checksum", "flip_bits",
]

#: the named models: "none" (the neutral default)
BUILTIN_FAULTS = (NoFaults(),)
for _f in BUILTIN_FAULTS:
    register(_f, overwrite=True)
del _f
