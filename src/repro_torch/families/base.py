"""The AlgorithmFamily interface: everything one FL algorithm family owns.

The paper's GenQSGD is one point in a family space its authors later
generalized (GQFedWAvg, arXiv 2306.07497): general weighted aggregation,
normalized momentum local updates, and a preconditioned quantizer — all
optimized by the same CGP/GIA machinery.  An :class:`AlgorithmFamily`
bundles the four seams a family needs into one object, so a new family
plugs into the whole pipeline (``Scenario`` → batched/fused GIA → reference
and SPMD runtimes → bit accounting) without touching any of those layers:

  varmap hook        ``make_varmap(N, with_extra, samples_per_worker)`` —
                     the decision-variable structure the optimizer sees
                     (what the old ``repro.api.registries.FAMILIES``
                     factories provided);
  convergence hooks  ``agg_eps`` / ``c_scales`` — how the family's
                     convergence bound reweights Theorem 1's posynomial
                     blocks.  The *shape* of the convergence block (term
                     counts per constraint) is family-independent, which is
                     what lets every family batch and fuse through
                     ``repro.opt.refresh`` / ``repro.opt.gia_jax``
                     unchanged; only the coefficients move;
  runtime hooks      ``agg_weights`` (server aggregation rule), plus the
                     ``momentum`` / ``normalize`` local-update fields
                     consumed by :mod:`repro.core.genqsgd` and
                     :mod:`repro.fed.runtime`;
  codec hook         ``codec_kind`` — the :func:`repro.compress.make_codec`
                     preconditioner variant the family quantizes with
                     ("qsgd" or "rotated"), priced consistently by
                     :class:`repro.core.cost.EdgeSystem`.

The base class implements GenQSGD's neutral behavior for every hook: the
``None`` returns of ``agg_eps`` / ``agg_weights`` select the *exact*
pre-family code paths (unweighted sums, plain mean aggregation), so routing
GenQSGD through this interface is bit-identical to the historical pipeline
— asserted by ``tests/unit/test_families.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..opt.problems import VarMap, identity_varmap

__all__ = ["AlgorithmFamily", "check_agg_weights", "check_momentum"]


def check_momentum(beta) -> float:
    """The ONE momentum-range validator (family + both runtime configs)."""
    beta = float(beta)
    if not (0.0 <= beta < 1.0):
        raise ValueError(f"momentum must be in [0, 1), got {beta}")
    return beta


def check_agg_weights(weights, n_workers: Optional[int] = None
                      ) -> Tuple[float, ...]:
    """The ONE validator for aggregation weights (family, Plan, and both
    runtime configs all accept them): coerces to a float tuple, requires
    strict positivity, and — when the worker count is known — the right
    length.  Keeping this shared stops the consumers' rules drifting."""
    w = tuple(float(x) for x in weights)
    if n_workers is not None and len(w) != n_workers:
        raise ValueError(f"{len(w)} aggregation weights for "
                         f"{n_workers} workers")
    if any(x <= 0 for x in w):
        raise ValueError(f"aggregation weights must be positive, got {w}")
    return w


@dataclasses.dataclass(frozen=True)
class AlgorithmFamily:
    """One FL algorithm family; frozen so instances key registries/caches.

    Fields are the runtime knobs every layer can read directly; behavioral
    variation goes through the overridable hook methods below.
    """

    key: str = "genqsgd"          # registry name == structure-signature key
    momentum: float = 0.0         # local-update momentum beta in [0, 1)
    normalize: bool = False       # normalized (unit-direction) local updates
    codec_kind: str = "qsgd"      # repro.compress.make_codec kind

    def __post_init__(self):
        check_momentum(self.momentum)

    # -- optimizer: decision variables ----------------------------------
    def make_varmap(self, N: int, with_extra: bool,
                    samples_per_worker: float) -> VarMap:
        """The family's decision-variable structure (paper Sec. VII)."""
        del samples_per_worker
        return identity_varmap(N, with_extra=with_extra)

    # -- optimizer: convergence-block reweighting -----------------------
    def agg_eps(self, N: int) -> Optional[np.ndarray]:
        """Effective participation weights ``eps_n = N * w_n`` entering the
        bound's ``sum_n eps_n K_n`` and ``sum_n q_n (eps_n K_n)^2`` blocks.

        ``None`` means uniform aggregation and selects the historical
        unweighted arithmetic verbatim (bit-identical, not merely equal).
        """
        del N
        return None

    def c_scales(self, N: int) -> Tuple[float, float]:
        """Multipliers ``(c2_scale, c3_scale)`` on Theorem 1's drift and
        sample-variance coefficients.

        ``c2_scale`` carries the momentum drift amplification
        ``1 / (1 - beta)`` of the normalized-momentum local update;
        ``c3_scale`` carries the weighted-aggregation variance factor
        ``N * sum_n w_n^2``  (== 1 for uniform weights).  Scales of exactly
        1.0 leave the coefficient objects untouched.
        """
        del N
        return 1.0, 1.0

    # -- runtime: server aggregation ------------------------------------
    def agg_weights(self, N: int) -> Optional[Tuple[float, ...]]:
        """Aggregation weights ``w_n`` (sum 1) for the server update, or
        ``None`` for the plain mean (the historical code path, bitwise)."""
        del N
        return None
