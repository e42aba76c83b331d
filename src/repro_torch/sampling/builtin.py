"""Built-in participation models.  This package carries only the neutral
one so far; uniform and importance cohorts are ROADMAP Queue 1, item 6.

``FullParticipation`` is the neutral base class re-exported under its
registry name.
"""
from __future__ import annotations

import dataclasses

from .base import SamplingModel

__all__ = ["FullParticipation"]


@dataclasses.dataclass(frozen=True)
class FullParticipation(SamplingModel):
    """Every worker in every round — the historical pipeline, verbatim."""

    key: str = "full"
