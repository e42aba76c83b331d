"""RunLedger: the per-round predicted-vs-measured drift timeline.

The paper's premise is that energy/time/comm-bits are *predictable* enough to
optimize over; :class:`~repro.api.plan.RunReport` already closes that loop at
end-of-run aggregates.  The ledger refines it to a per-round timeline: for
every executed round, what the Plan budgeted (``predicted_T / K0``,
``expected_round_bits()``, ``predicted_E / K0``) next to what the run
realized (the FaultTrace's deadline-cut round times, the sampled cohort's
wire bits, the cost model at the executed rounds), plus running cumulative
drift ratios.

A ledger is a **pure function of the frozen RunReport** — it reads no clocks
and no global state — so ``RunReport.drift()`` returns the identical object
whether observability is enabled or not (the observer-effect suite asserts
this).  Wall-clock timings live in spans and metrics, never here.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Tuple

__all__ = ["LedgerRow", "RunLedger"]


def _ratio(measured: float, predicted: float) -> float:
    """Relative drift (measured/predicted - 1); NaN when undefined."""
    if not math.isfinite(predicted) or predicted == 0.0:
        return math.nan
    return measured / predicted - 1.0


@dataclasses.dataclass(frozen=True)
class LedgerRow:
    """One round's predicted-vs-measured entry (all per-round quantities)."""

    round: int
    predicted_time_s: float
    measured_time_s: float
    predicted_bits: float
    measured_bits: float
    predicted_energy_j: float
    measured_energy_j: float
    # running totals through this round, and their relative drift
    cum_predicted_time_s: float
    cum_measured_time_s: float
    cum_predicted_bits: float
    cum_measured_bits: float
    cum_predicted_energy_j: float
    cum_measured_energy_j: float
    drift_time: float
    drift_bits: float
    drift_energy: float

    def to_json(self) -> Dict[str, object]:
        # not dataclasses.asdict: that deep-copies every leaf, and the
        # ledger write sits on Scenario.run's obs-enabled exit path
        return {name: getattr(self, name) for name in _ROW_FIELDS}


_ROW_FIELDS = tuple(f.name for f in dataclasses.fields(LedgerRow))

# rows are a fixed all-number schema, so to_jsonl renders them through a
# %-template instead of per-row json.dumps (~5x cheaper; the write sits on
# Scenario.run's obs-enabled exit path).  repr(float) round-trips exactly,
# so load_jsonl reconstructs bit-identical rows.
_ROW_TEMPLATE = ("{" + ", ".join(f'"{n}": %s' for n in _ROW_FIELDS) + "}")


def _jnum(v) -> str:
    """JSON number token for ``v`` (json.loads-compatible, incl. NaN/inf)."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    return repr(v)


def _row_line(row: LedgerRow) -> str:
    return _ROW_TEMPLATE % ((row.round,) + tuple(
        _jnum(getattr(row, n)) for n in _ROW_FIELDS[1:]))


@dataclasses.dataclass(frozen=True)
class RunLedger:
    """Per-round drift ledger of one run; built by ``RunReport.drift()``."""

    rows: Tuple[LedgerRow, ...] = ()
    backend: str = ""
    family: str = ""

    @classmethod
    def from_report(cls, report) -> "RunLedger":
        """Build the timeline from a frozen RunReport.

        Per-round predictions are the Plan's totals amortized over its
        planned ``K0`` (the cost models are linear in the round count, so
        this is exact, not an approximation).  Per-round measurements use
        the finest trace the report carries: realized round times from the
        FaultTrace when faults ran, realized cohort bits from
        ``round_bits_trace`` when sampling ran — falling back to the
        uniform per-round share of the measured totals, which is exact for
        deterministic full-participation runs.
        """
        plan = report.plan
        R = int(report.rounds)
        pred_t = plan.predicted_T / plan.K0
        pred_e = plan.predicted_E / plan.K0
        pred_b = plan.expected_round_bits()

        ft = report.fault_trace
        fault_t = None
        if ft is not None and len(ft) >= R:
            fault_t = [r.t_round for r in ft.records[:R]]
        bits_tr = report.round_bits_trace
        have_bits = len(bits_tr) >= R

        meas_e = report.measured_E / R if R else math.nan
        rows: List[LedgerRow] = []
        cpt = cpe = cpb = 0.0
        cmt = cme = cmb = 0.0
        for r in range(R):
            mt = fault_t[r] if fault_t is not None else (
                report.measured_T / R)
            mb = float(bits_tr[r]) if have_bits else (report.comm_bits / R)
            cpt += pred_t
            cpe += pred_e
            cpb += pred_b
            cmt += mt
            cme += meas_e
            cmb += mb
            rows.append(LedgerRow(
                round=r,
                predicted_time_s=pred_t, measured_time_s=mt,
                predicted_bits=pred_b, measured_bits=mb,
                predicted_energy_j=pred_e, measured_energy_j=meas_e,
                cum_predicted_time_s=cpt, cum_measured_time_s=cmt,
                cum_predicted_bits=cpb, cum_measured_bits=cmb,
                cum_predicted_energy_j=cpe, cum_measured_energy_j=cme,
                drift_time=_ratio(cmt, cpt),
                drift_bits=_ratio(cmb, cpb),
                drift_energy=_ratio(cme, cpe)))
        return cls(rows=tuple(rows), backend=report.backend,
                   family=plan.family)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.rows)

    def cumulative(self) -> Dict[str, float]:
        """Final cumulative drift ratios (empty run: all NaN)."""
        if not self.rows:
            return {"drift_time": math.nan, "drift_bits": math.nan,
                    "drift_energy": math.nan}
        last = self.rows[-1]
        return {"drift_time": last.drift_time,
                "drift_bits": last.drift_bits,
                "drift_energy": last.drift_energy}

    def to_jsonl(self, path: str) -> str:
        """One JSON object per round, plus a trailing summary line."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        lines = [_row_line(row) for row in self.rows]
        lines.append(json.dumps({"summary": True, "backend": self.backend,
                                 "family": self.family,
                                 "rounds": len(self.rows),
                                 **self.cumulative()}))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    @classmethod
    def load_jsonl(cls, path: str) -> "RunLedger":
        rows = []
        backend = family = ""
        with open(path) as f:
            for line in f:
                doc = json.loads(line)
                if doc.get("summary"):
                    backend = doc.get("backend", "")
                    family = doc.get("family", "")
                    continue
                rows.append(LedgerRow(**doc))
        return cls(rows=tuple(rows), backend=backend, family=family)

    def summary(self) -> str:
        c = self.cumulative()
        return (f"RunLedger[{self.backend}/{self.family}] "
                f"{len(self.rows)} rounds | cumulative drift: "
                f"time {c['drift_time']:+.3%} "
                f"bits {c['drift_bits']:+.3%} "
                f"energy {c['drift_energy']:+.3%}")
