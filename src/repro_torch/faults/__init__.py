"""repro_torch.faults: seeded fault injection + deadline-HT aggregation.

Pluggable fault models (mirroring :mod:`repro_torch.sampling` /
:mod:`repro_torch.families`): each model contributes availability /
worst-case margin coefficients to the optimizer, and a seeded per-round
fault draw (straggler latency inflation, multi-round crashes,
checksum-failing payload corruption) to the reference runtime, aggregated
past a per-round deadline with unbiased Horvitz-Thompson reweighting of
the survivors.

    from repro_torch.api import Scenario
    from repro_torch.faults import edge_faults

    fm = edge_faults(straggler_prob=0.2, straggler_factor=4.0,
                     crash_prob=0.05, deadline_slack=1.5)
    scn = Scenario(..., faults=fm)
    plan = scn.optimize()                 # plans for availability
    report = scn.run(plan)                # report.fault_trace
"""
from .base import (FaultDriver, FaultModel, FaultSpec, FaultTrace,
                   RoundFaultRecord, RoundFaults, fault_rng, flip_bits,
                   payload_checksum)
from .builtin import EdgeFaults, NoFaults, edge_faults
from .registry import fault_names, get_faults, register, resolve

__all__ = [
    "FaultModel", "NoFaults", "EdgeFaults", "edge_faults",
    "register", "get_faults", "fault_names", "resolve",
    "FaultDriver", "FaultSpec", "FaultTrace", "RoundFaults",
    "RoundFaultRecord", "fault_rng", "payload_checksum", "flip_bits",
]

#: the named models: "none" (the neutral default) and "edge" (all-zero
#: probabilities until configured — use the edge_faults factory)
BUILTIN_FAULTS = (NoFaults(), EdgeFaults())
for _f in BUILTIN_FAULTS:
    register(_f, overwrite=True)
del _f
