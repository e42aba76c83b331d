"""The shipped algorithm families.

``GenQSGDFamily`` covers the paper's four parameterizations (GenQSGD with
every variable free, plus the PM-SGD / FedAvg / PR-SGD baselines obtained by
pinning/tying variables through a ``VarMap``) — all hooks neutral, so the
optimizer and runtimes follow the exact historical code paths.

``GQFedWAvgFamily`` is the authors' follow-up family (arXiv 2306.07497)
adapted onto the Theorem-1 machinery this repo reproduces:

  * **general weighted aggregation** — the server update is
    ``x̂ += γ · Σ_n w_n Q(Δ_n)`` instead of the mean.  In the bound the
    weights enter through ``Σ_n ε_n K_n`` (effective local work,
    ``ε_n = N w_n``), the ε²-weighted quantization-variance block
    ``Σ_n q_n (ε_n K_n)²``, and the sample-variance factor
    ``N Σ_n w_n²`` on c3 — all coefficient-only changes, so the family
    batches and fuses through ``repro.opt.refresh`` / ``gia_jax``
    unchanged;
  * **normalized momentum local updates** — workers run
    ``v ← β v + (1-β) g;  x ← x − γ v/‖v‖``.  We fold the momentum drift
    amplification into the bound as ``c2 → c2 / (1-β)`` (the momentum
    buffer averages the last ~1/(1-β) drifting gradients); the
    normalization itself is a runtime property that does not change the
    bound's posynomial structure;
  * **rotation-preconditioned quantization** — deltas are preconditioned
    with a randomized Hadamard rotation before QSGD
    (:class:`repro.compress.RotatedQSGDCodec`); ``codec_kind="rotated"``
    makes :class:`repro.core.cost.EdgeSystem` price exactly the rotated
    wire format (padded-to-pow2 levels + the 32-bit rotation seed) the
    reference runtime sends.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from ..opt.problems import (VarMap, fa_varmap, identity_varmap, pm_varmap,
                            pr_varmap)
from .base import AlgorithmFamily, check_agg_weights

__all__ = ["GenQSGDFamily", "GQFedWAvgFamily", "BUILTIN_FAMILIES"]

#: varmap-factory spellings of the paper's Sec.-VII parameterizations;
#: factory(N, with_extra, samples_per_worker) -> VarMap
_VARMAPS = {
    "genqsgd": lambda N, we, spw: identity_varmap(N, with_extra=we),
    "pm": lambda N, we, spw: pm_varmap(N, with_extra=we),
    "fa": lambda N, we, spw: fa_varmap(N, [float(spw)] * N, with_extra=we),
    "pr": lambda N, we, spw: pr_varmap(N, with_extra=we),
}


@dataclasses.dataclass(frozen=True)
class GenQSGDFamily(AlgorithmFamily):
    """The paper's family: plain-SGD local updates, mean aggregation, QSGD.

    ``varmap_factory`` selects the decision-variable structure (free /
    PM / FA / PR); every other hook keeps the base class's neutral —
    bit-identical — behavior.
    """

    varmap_factory: Optional[Callable[..., VarMap]] = None

    def make_varmap(self, N: int, with_extra: bool,
                    samples_per_worker: float) -> VarMap:
        factory = self.varmap_factory or _VARMAPS["genqsgd"]
        return factory(N, with_extra, samples_per_worker)


@dataclasses.dataclass(frozen=True)
class GQFedWAvgFamily(AlgorithmFamily):
    """GQFedWAvg: weighted aggregation + normalized momentum + rotation.

    ``weights`` are the (unnormalized) aggregation weights ``w_n``; ``None``
    means uniform.  Register variants under their own keys to sweep weight
    schedules::

        from repro_torch.families import GQFedWAvgFamily, register
        register(GQFedWAvgFamily(key="gqfedwavg-front",
                                 weights=(4.0, 2.0, 1.0, 1.0)))
    """

    key: str = "gqfedwavg"
    momentum: float = 0.5
    normalize: bool = True
    codec_kind: str = "rotated"
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        super().__post_init__()
        if self.weights is not None:
            object.__setattr__(self, "weights",
                               check_agg_weights(self.weights))

    def _w(self, N: int) -> Optional[np.ndarray]:
        if self.weights is None:
            return None
        if len(self.weights) != N:
            raise ValueError(f"family {self.key!r} has {len(self.weights)} "
                             f"aggregation weights for N={N} workers")
        w = np.asarray(self.weights, dtype=np.float64)
        return w / w.sum()

    # -- optimizer hooks -------------------------------------------------
    def agg_eps(self, N: int) -> Optional[np.ndarray]:
        w = self._w(N)
        return None if w is None else N * w

    def c_scales(self, N: int) -> Tuple[float, float]:
        c2s = 1.0 / (1.0 - self.momentum)
        w = self._w(N)
        c3s = 1.0 if w is None else float(N * np.sum(w * w))
        return c2s, c3s

    # -- runtime hooks ---------------------------------------------------
    def agg_weights(self, N: int) -> Optional[Tuple[float, ...]]:
        w = self._w(N)
        return None if w is None else tuple(float(x) for x in w)


#: day-one registry contents, in registration order
BUILTIN_FAMILIES = (
    GenQSGDFamily(key="genqsgd", varmap_factory=_VARMAPS["genqsgd"]),
    GenQSGDFamily(key="pm", varmap_factory=_VARMAPS["pm"]),
    GenQSGDFamily(key="fa", varmap_factory=_VARMAPS["fa"]),
    GenQSGDFamily(key="pr", varmap_factory=_VARMAPS["pr"]),
    GQFedWAvgFamily(),
)
