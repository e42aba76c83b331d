"""Scenario sweeps and Pareto fronts: the batched front door of
:mod:`repro_torch.api`.

The paper's headline results are sweeps — energy vs. ``C_max``/``T_max``
trade-off surfaces (Fig. 5), baseline tables across step-size rules — and
follow-up work (GQFedWAvg, Cost-Effective Federated Learning) frames the
same design space as budget sweeps and Pareto exploration.  This module
makes that a first-class operation:

    report = scenario.sweep(over={"C_max": [0.2, 0.25, 0.3],
                                  "rule": [ConstantRule(0.01), None]})
    front  = report.pareto_front()          # non-dominated (E, T, C) points
    report.to_csv("results/sweep.csv")

Scenarios are grouped by optimizer structure signature ``(m, family, N)``;
each group solves through one batched GIA call path
(:func:`repro_torch.opt.solve_param_opt_batched` — by default the *fused*
device-resident loop of :mod:`repro_torch.opt.gia_fused` on the card, one
captured step program per group, surrogate refresh included), and
independent groups can solve concurrently on a small thread pool.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .. import resolve_device
from ..opt.gia import solve_param_opt_batched
from ..opt.gp import refuse_jax_backend
from ..opt.structure import structure_signature
from .plan import Plan

__all__ = ["SweepReport", "sweep_scenarios", "expand_grid"]

#: user-facing spellings of Scenario fields accepted in ``sweep(over=...)``
_ALIASES = {"rule": "step", "cmax": "C_max", "tmax": "T_max"}


def expand_grid(base, over: Mapping[str, Iterable]):
    """Cartesian-expand ``over`` into Scenario variants of ``base``.

    Keys are Scenario field names (``"rule"``/``"cmax"``/``"tmax"`` aliases
    accepted); values are iterables of field values (``step`` values are
    StepRule instances or None for the jointly-optimized objective).

    The special axis ``"N"`` sweeps the worker count: the edge system is
    ceil-tiled to N workers via
    :meth:`~repro_torch.core.cost.EdgeSystem.resized`
    and the ML-problem constants follow — combined with a free-``S``
    ``sampling`` model this sweeps the energy-vs-N participation frontier
    in one batched call.
    """
    fields = {f.name for f in dataclasses.fields(base)}
    keys, grids = [], []
    for k, vals in over.items():
        canon = _ALIASES.get(k, k)
        if canon != "N" and canon not in fields:
            raise ValueError(
                f"cannot sweep over {k!r}; Scenario fields are "
                f"{sorted(fields)} + ['N'] (aliases: {sorted(_ALIASES)})")
        if canon in keys:
            raise ValueError(f"duplicate sweep axis {canon!r}")
        keys.append(canon)
        grids.append(list(vals))
    scenarios = []
    for combo in itertools.product(*grids):
        kv = dict(zip(keys, combo))
        n_new = kv.pop("N", None)
        s = base
        if n_new is not None:
            s = dataclasses.replace(
                s, system=s.system.resized(int(n_new)),
                consts=dataclasses.replace(s.consts, N=int(n_new)))
        scenarios.append(dataclasses.replace(s, **kv) if kv else s)
    return scenarios


@dataclasses.dataclass(frozen=True)
class SweepReport:
    """Tidy result of one sweep: one row + one :class:`Plan` per scenario.

    Rows are plain dicts (name, family, m, gamma, T_max, C_max, K0, Kn, B,
    E, T, C, feasible, converged, iterations) in sweep order — ready for a
    dataframe, a CSV, or the Pareto filter.
    """

    rows: Tuple[dict, ...]
    plans: Tuple[Plan, ...]
    backend: str
    n_groups: int
    wall_time_s: float

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    # ------------------------------------------------------------------
    def pareto_front(self, objectives: Sequence[str] = ("E", "T", "C"),
                     feasible_only: bool = True) -> "SweepReport":
        """The non-dominated subset, minimizing every objective column.

        A point is dominated when another point is no worse in every
        objective and strictly better in at least one; ties survive.
        """
        idx = [i for i, r in enumerate(self.rows)
               if r["feasible"] or not feasible_only]
        if not idx:
            return dataclasses.replace(self, rows=(), plans=())
        P = np.array([[float(self.rows[i][k]) for k in objectives]
                      for i in idx])
        le = np.all(P[:, None, :] <= P[None, :, :], axis=-1)
        lt = np.any(P[:, None, :] < P[None, :, :], axis=-1)
        dominated = np.any(le & lt, axis=0)          # [j] : exists i beating j
        keep = [i for i, d in zip(idx, dominated) if not d]
        return dataclasses.replace(
            self, rows=tuple(self.rows[i] for i in keep),
            plans=tuple(self.plans[i] for i in keep))

    def best(self, key: str = "E", feasible_only: bool = True):
        """(row, plan) minimizing ``key`` (among feasible rows by default)."""
        idx = [i for i, r in enumerate(self.rows)
               if r["feasible"] or not feasible_only]
        if not idx:
            raise ValueError("no feasible rows in sweep")
        i = min(idx, key=lambda i: self.rows[i][key])
        return self.rows[i], self.plans[i]

    def to_csv(self, path: str, columns: Optional[Sequence[str]] = None):
        """Write the tidy rows; tuple cells (Kn) are |-joined."""
        cols = list(columns) if columns else list(self.rows[0]) if self.rows \
            else []
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for r in self.rows:
                f.write(",".join(
                    "|".join(str(x) for x in v) if isinstance(v, tuple)
                    else str(v) for v in (r.get(c, "") for c in cols)) + "\n")
        return path


def _resolve_backend(backend: str) -> str:
    """``"auto"`` is the fused engine; the JAX package's names are refused
    (``ValueError`` naming the port's counterparts)."""
    refuse_jax_backend(backend)
    return "torch-fused" if backend == "auto" else backend


def sweep_scenarios(scenarios: Sequence, names: Optional[Sequence[str]] = None,
                    backend: str = "auto", tol: float = 1e-4,
                    max_iter: int = 60, parallel: bool = True,
                    device="cuda") -> SweepReport:
    """Optimize many scenarios through the batched solver engine.

    Scenarios are grouped by structure signature; each group is one
    :func:`~repro_torch.opt.gia.solve_param_opt_batched` call — with the
    default ``backend="auto"`` (``"torch-fused"``) the group's whole GIA
    (surrogate refresh + interior point + convergence masks) is one step
    program captured once per signature on ``device`` and replayed in
    chunks, so a 1024-point single-signature grid is one capture and one
    host read per chunk (``backend="torch"`` keeps the per-iteration batched
    GP solves with a host-side refresh; ``"numpy"`` is the scalar reference
    on the host) — and groups run concurrently on a small thread pool when
    ``parallel``.  Heterogeneous scenario lists (mixed families / step
    rules / systems) are fine — that's what the grouping is for.
    """
    scenarios = list(scenarios)
    if names is not None:
        names = list(names)
        if len(names) != len(scenarios):
            raise ValueError(f"{len(names)} names for {len(scenarios)} "
                             f"scenarios")
    t_start = time.time()
    resolved = _resolve_backend(backend)
    if resolved != "numpy":
        resolve_device(device)          # no card and not "cpu": raise here
    ms = [s.objective for s in scenarios]
    probs = [s.problem() for s in scenarios]
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(probs):
        groups.setdefault(structure_signature(p), []).append(i)

    def solve_group(idxs: List[int]):
        return solve_param_opt_batched([probs[i] for i in idxs], tol=tol,
                                       max_iter=max_iter, backend=resolved,
                                       device=device)

    results = [None] * len(scenarios)
    group_lists = list(groups.values())
    if parallel and len(group_lists) > 1:
        workers = min(len(group_lists), os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for idxs, rs in zip(group_lists,
                                pool.map(solve_group, group_lists)):
                for i, r in zip(idxs, rs):
                    results[i] = r
    else:
        for idxs in group_lists:
            for i, r in zip(idxs, solve_group(idxs)):
                results[i] = r

    rows, plans = [], []
    for i, (scn, m, r) in enumerate(zip(scenarios, ms, results)):
        plan = scn._plan_from_result(m, r)
        name = (names[i] if names is not None
                else f"{scn.family_key}-{m.value}")
        rows.append({
            "name": name, "family": scn.family_key, "m": m.value,
            "gamma": plan.gamma, "T_max": scn.T_max, "C_max": scn.C_max,
            "K0": plan.K0, "Kn": plan.Kn, "B": plan.B,
            "N": plan.N, "S": plan.cohort_S, "sampling": plan.sampling,
            "E": plan.predicted_E, "T": plan.predicted_T,
            "C": plan.predicted_C, "feasible": plan.feasible,
            "converged": plan.converged, "iterations": r.iterations,
        })
        plans.append(plan)
    return SweepReport(rows=tuple(rows), plans=tuple(plans), backend=resolved,
                       n_groups=len(groups), wall_time_s=time.time() - t_start)
