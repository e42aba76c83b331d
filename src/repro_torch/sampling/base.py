"""The SamplingModel interface: client sampling / partial participation
as a first-class, pluggable piece of the optimization problem.

The paper assumes all N workers participate in every round, but production
cross-device FL samples a small cohort per round — the regime both
"Cost-Effective Federated Learning" papers (arXiv 2109.05411, 2012.08336)
show must be co-optimized with convergence.  A :class:`SamplingModel`
bundles the seams a participation model needs, mirroring how
:class:`repro.families.AlgorithmFamily` wraps the algorithm:

  varmap hook        ``extend_varmap`` — free-cohort models append a new GP
                     decision variable ``S`` (cohort size) to the family's
                     varmap; expected costs and the inflated convergence
                     block stay posynomial in (S, Kn, B), so sampled
                     problems batch and fuse through ``repro.opt.refresh``
                     / ``repro.opt.gia_jax`` unchanged;
  convergence hooks  ``q_coeffs`` / ``c3_scale`` — partial participation
                     inflates Theorem 1's variance blocks: with inclusion
                     probability ``pi_n`` the per-worker quantization block
                     coefficient ``q_n`` becomes ``(q_n + 1 - pi_n)/pi_n``
                     (quantization noise divided by ``pi_n`` plus the
                     participation-noise term ``(1-pi_n)/pi_n``; exactly
                     ``q_n`` at ``pi_n = 1``) and the sample-variance
                     coefficient ``c3`` picks up ``(1/N) sum_n 1/pi_n``
                     (``N/S`` for uniform cohorts; exactly 1 at S=N);
  cost hooks         ``pi`` / ``base_p`` / ``pi_at`` — the inclusion
                     probabilities that turn the energy objective into an
                     *expected* energy (each worker's compute and upload
                     terms scale by ``pi_n``); the time constraints stay
                     worst-case over all N workers (E[max over a random
                     cohort] is not posynomial — a deliberately
                     conservative modeling choice, noted in ROADMAP.md);
  runtime hooks      the module-level :func:`draw_cohort` /
                     :func:`cohort_weights` helpers — a seeded per-round
                     cohort draw plus the Horvitz-Thompson reweighting
                     ``u_n = mask_n * w_n / pi_n`` that keeps the server
                     aggregation unbiased (``E[sum_n u_n d_n] = sum_n w_n
                     d_n`` for any aggregation weights ``w``), consumed by
                     :mod:`repro.core.genqsgd` and
                     :mod:`repro.train.trainer`.

For free-``S`` models the GP constraint must be posynomial in ``S``.  The
exact per-worker factor ``(q_n + 1 - pi_n)/pi_n`` is not (the ``-pi_n``
makes it a signomial), but no relaxation is paid: the convergence
constraint is kept *exact* in ratio form — the positive part
``[(q_n+1)/p_n] * S^{-1}`` stays in the numerator and the ``-1`` part
moves to the denominator, which ``repro.opt.condense.ratio_to_posy``
AM-GM-condenses around the previous iterate (conservative inner
approximation, tight at the expansion point — the standard GIA
condensation contract, zero slack at convergence).  Pinned-``S`` models
keep the exact factor directly (a pure coefficient change, so a pinned
sampled problem shares the *compiled program* of the unsampled one while
keying its own cache pool).

The base class implements full participation for every hook: the ``None``
/ ``1.0`` returns select the exact pre-sampling code paths, so routing an
unsampled (or ``uniform(S=N)``) scenario through this interface is
bit-identical to the historical pipeline — asserted by
``tests/unit/test_sampling.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..opt.posy import Posy
from ..opt.problems import VarMap

__all__ = ["SamplingModel", "widen_varmap", "draw_cohort", "cohort_weights",
           "draw_cohort_weights", "check_probs"]


def check_probs(p, n_workers: Optional[int] = None) -> Tuple[float, ...]:
    """The ONE validator for per-worker sampling probabilities ``p_n``:
    coerces to a float tuple, requires strict positivity and sum 1, and —
    when the worker count is known — the right length."""
    w = tuple(float(x) for x in p)
    if n_workers is not None and len(w) != n_workers:
        raise ValueError(f"{len(w)} sampling probabilities for "
                         f"{n_workers} workers")
    if any(x <= 0 for x in w):
        raise ValueError(f"sampling probabilities must be positive, got {w}")
    if abs(sum(w) - 1.0) > 1e-9:
        raise ValueError(f"sampling probabilities must sum to 1, "
                         f"got sum {sum(w)}")
    return w


def _widen(p: Optional[Posy], n_new: int) -> Optional[Posy]:
    """The posynomial re-expressed over ``n_new`` variables (zero exponents
    on the appended ones) — coefficients untouched."""
    if p is None:
        return None
    pad = np.zeros((p.A.shape[0], n_new - p.A.shape[1]))
    return Posy(p.c.copy(), np.concatenate([p.A, pad], axis=1))


def widen_varmap(vmap: VarMap, name: str, lower: float, upper: float
                 ) -> VarMap:
    """``vmap`` with one new boxed variable appended (after every existing
    one, ``extra`` included, so positional assumptions elsewhere —
    ``names.index("extra")``, the z_init coordinate fills — stay valid)."""
    n = vmap.n + 1
    lo = np.full(n, 1e-12)
    up = np.full(n, 1e12)
    if vmap.lower is not None:
        lo[:n - 1] = vmap.lower
    if vmap.upper is not None:
        up[:n - 1] = vmap.upper
    lo[n - 1] = float(lower)
    up[n - 1] = float(upper)
    return VarMap(n=n, names=list(vmap.names) + [str(name)],
                  K0=_widen(vmap.K0, n),
                  Kn=[_widen(k, n) for k in vmap.Kn],
                  B=_widen(vmap.B, n), T1=_widen(vmap.T1, n),
                  T2=_widen(vmap.T2, n), extra=_widen(vmap.extra, n),
                  lower=lo, upper=up)


@dataclasses.dataclass(frozen=True)
class SamplingModel:
    """One participation model; frozen so instances key registries/caches.

    The base class *is* full participation: every hook returns the neutral
    value selecting the historical code path bitwise.
    """

    key: str = "full"             # registry name == structure-signature key

    # -- identity --------------------------------------------------------
    def validate(self, N: int) -> None:
        """Fail loudly on an N-mismatched model (length of p, S > N)."""
        del N

    def is_neutral(self, N: int) -> bool:
        """True when the model is full participation in disguise — every
        hook must then return its neutral value so the pipeline is
        bit-identical to the unsampled one."""
        del N
        return True

    def signature(self, N: int) -> tuple:
        """The structure-signature element.  Neutral models report
        ``("full",)`` so they share the default problems' compile/cache
        pools; genuinely sampled models must differ from it (and from each
        other when their conv-block coefficients differ)."""
        del N
        return ("full",)

    # -- optimizer: decision variables -----------------------------------
    @property
    def free_S(self) -> bool:
        """Whether the cohort size is a GP decision variable ``S``."""
        return False

    def s_cap(self, N: int) -> float:
        """Upper bound on the cohort size (keeps every ``pi_n <= 1``)."""
        return float(N)

    def pinned_S(self, N: int) -> Optional[int]:
        """The fixed cohort size of a pinned model (None = full or free)."""
        del N
        return None

    def extend_varmap(self, vmap: VarMap, N: int) -> VarMap:
        """Append the model's decision variables (free-``S`` models append
        ``"S"`` with box ``[1, s_cap]``); pinned/full models are a no-op."""
        del N
        return vmap

    # -- optimizer: expected-cost / convergence coefficients --------------
    def pi(self, N: int) -> Optional[np.ndarray]:
        """Pinned per-worker inclusion probabilities ``pi_n`` (None = full
        participation or free-``S`` — use :meth:`pi_at` for the latter)."""
        del N
        return None

    def base_p(self, N: int) -> Optional[np.ndarray]:
        """Free-``S`` base probabilities ``p_n`` with ``pi_n = p_n * S``
        (None for pinned/full models)."""
        del N
        return None

    def pi_at(self, N: int, S: Optional[float] = None
              ) -> Optional[np.ndarray]:
        """Inclusion probabilities at a concrete cohort size (None = the
        historical full-participation costs, verbatim)."""
        if self.free_S:
            if S is None:
                raise ValueError(f"sampling model {self.key!r} optimizes S; "
                                 f"pass the cohort size")
            return float(S) * self.base_p(N)
        return self.pi(N)

    def q_coeffs(self, q_pairs: np.ndarray, N: int) -> Optional[np.ndarray]:
        """The quantization-block coefficients with the participation
        inflation folded in (None = historical ``q_pairs``, bitwise).

        Pinned models return the exact ``(q_n + 1 - pi_n)/pi_n``; free-``S``
        models return the ``S``-independent *numerator* part of the exact
        ratio form, ``(q_n + 1)/p_n`` — the caller multiplies by ``S^{-1}``
        and moves the ``-1`` part into the condensed denominator, so the
        constraint stays exact.  Concrete-``S`` evaluation goes through
        :meth:`q_coeffs_at`.
        """
        del q_pairs, N
        return None

    def q_coeffs_at(self, q_pairs: np.ndarray, N: int,
                    S: Optional[float] = None) -> Optional[np.ndarray]:
        """The *exact* inflated coefficients ``(q_n + 1 - pi_n)/pi_n`` at a
        concrete cohort size (None = historical ``q_pairs``, bitwise).

        This is what ``evaluate`` / integer recovery / the feasibility flag
        use — the same surrogate-vs-validation split m=E's Taylor
        constraints already follow, so the reported bound is always the
        exact one.  Positive whenever every ``pi_n <= 1`` — guaranteed by
        ``s_cap``.
        """
        if not self.free_S:
            return self.q_coeffs(q_pairs, N)
        pi = self.pi_at(N, S)
        return (np.asarray(q_pairs, np.float64) + 1.0 - pi) / pi

    def c3_scale(self, N: int) -> float:
        """Multiplier on Theorem 1's sample-variance coefficient ``c3``:
        ``(1/N) sum_n 1/pi_n`` (free-``S``: its ``S``-independent part
        ``(1/N) sum_n 1/p_n``; the caller multiplies by ``S^{-1}``).
        Exactly 1.0 leaves the coefficient bitwise untouched."""
        del N
        return 1.0

    def plan_p(self, N: int) -> Optional[Tuple[float, ...]]:
        """The probabilities a frozen Plan must carry to reproduce the
        runtime draw (None = uniform / full)."""
        del N
        return None


# ---------------------------------------------------------------------------
# runtime: seeded cohort draws + unbiased reweighting
# ---------------------------------------------------------------------------
def draw_cohort(rng: np.random.Generator, N: int, S: int, p=None):
    """One per-round cohort: exactly ``S`` distinct workers of ``N``.

    ``p=None`` draws uniformly without replacement (inclusion probability
    ``S/N`` each).  Otherwise ``p`` are per-worker base probabilities and
    the draw is systematic PPS sampling — cumulate ``pi = S*p``, place
    ``S`` equispaced points at a common uniform offset — which yields a
    fixed-size cohort with inclusion probabilities *exactly* ``pi_n``
    whenever every ``pi_n <= 1`` (guaranteed by the model's ``s_cap``).

    Returns ``(idx, pi)`` — sorted cohort indices and the length-N
    inclusion-probability vector.
    """
    S = int(S)
    if p is None:
        idx = np.sort(rng.choice(N, size=S, replace=False))
        pi = np.full(N, float(S) / N)
    else:
        pi = float(S) * np.asarray(p, dtype=np.float64)
        points = rng.uniform(0.0, 1.0) + np.arange(S)
        idx = np.searchsorted(np.cumsum(pi), points, side="right")
        idx = np.minimum(idx, N - 1)       # fp guard at the last cum point
    return idx, pi


def cohort_weights(idx: np.ndarray, pi: np.ndarray, N: int,
                   agg_weights=None) -> np.ndarray:
    """The Horvitz-Thompson aggregation vector ``u_n = mask_n * w_n / pi_n``.

    ``w`` are the (normalized) server aggregation weights — the plain mean
    ``w_n = 1/N`` when ``agg_weights`` is None.  ``E[sum_n u_n d_n] =
    sum_n w_n d_n`` over cohort draws, so the sampled round is an unbiased
    estimate of the full-participation round for any family weighting.
    """
    w = (np.full(N, 1.0 / N) if agg_weights is None
         else np.asarray(agg_weights, dtype=np.float64)
         / float(np.sum(agg_weights)))
    u = np.zeros(N)
    u[idx] = w[idx] / pi[idx]
    return u


def draw_cohort_weights(rng: np.random.Generator, N: int, S: int, p=None,
                        agg_weights=None):
    """One round's ``(idx, u)``: seeded cohort draw + unbiased weights."""
    idx, pi = draw_cohort(rng, N, S, p)
    return idx, cohort_weights(idx, pi, N, agg_weights)
