"""Built-in fault models.  This package carries only the fault-free fleet
so far; the edge-fleet model is ROADMAP Queue 1, item 6."""
from __future__ import annotations

import dataclasses

from .base import FaultModel

__all__ = ["NoFaults"]


@dataclasses.dataclass(frozen=True)
class NoFaults(FaultModel):
    """The fault-free fleet — every hook neutral; selecting it is
    bit-identical to configuring no fault model at all."""

    key: str = "none"
