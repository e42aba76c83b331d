"""Low-overhead metrics primitives: counters, gauges, histograms.

Design constraints:

* **Off by default, provably inert.**  Every instrument holds a reference to a
  :class:`Switch`; when the switch is off, ``inc``/``set``/``observe`` return
  after a single attribute check and no state mutates.  The global registry
  (:data:`REGISTRY`) is gated on the process-wide switch flipped by
  ``repro.obs.enable()``.  Components that must *always* measure (PlanServer's
  ``stats()`` is a public API, not an opt-in) construct their own registry with
  an always-on switch.
* **No device interaction.**  Instruments only touch host Python state, so they
  can be called from jitted-function *host* call sites without adding compiles
  or syncs.
* **Thread-safe.**  Each instrument carries its own lock; the registry guards
  get-or-create with another.  Locks are only taken when the switch is on.

Histograms keep raw samples (bounded reservoir) so they can serve exact
p50/p95/p99 for the sample sizes this repo sees (1e2..1e5 observations).
"""
from __future__ import annotations

import math
import random
import threading
from typing import Dict, List, Optional, Tuple


class Switch:
    """A shared boolean flag instruments check before recording."""

    __slots__ = ("on",)

    def __init__(self, on: bool = True):
        self.on = bool(on)


#: Process-wide switch controlled by ``repro.obs.enable()`` / ``disable()``.
GLOBAL_SWITCH = Switch(False)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join('%s="%s"' % (k, v) for k, v in labels)
    return "{%s}" % inner


class _Instrument:
    __slots__ = ("name", "labels", "_switch", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...], switch: Switch):
        self.name = name
        self.labels = labels
        self._switch = switch
        self._lock = threading.Lock()

    @property
    def full_name(self) -> str:
        return self.name + _format_labels(self.labels)


class Counter(_Instrument):
    """Monotonically increasing counter."""

    __slots__ = ("value",)

    def __init__(self, name, labels, switch):
        super().__init__(name, labels, switch)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._switch.on:
            return
        with self._lock:
            self.value += n


class Gauge(_Instrument):
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self, name, labels, switch):
        super().__init__(name, labels, switch)
        self.value = 0.0

    def set(self, v: float) -> None:
        if not self._switch.on:
            return
        with self._lock:
            self.value = float(v)

    def add(self, dv: float) -> None:
        if not self._switch.on:
            return
        with self._lock:
            self.value += dv


class Histogram(_Instrument):
    """Sample histogram with exact percentiles over a bounded reservoir.

    Keeps up to ``maxlen`` raw samples; beyond that, new samples overwrite a
    pseudo-random slot (seeded RNG, so runs are reproducible).  ``count``,
    ``total``, ``min`` and ``max`` always reflect every observation.
    """

    __slots__ = ("_samples", "count", "total", "vmin", "vmax", "_maxlen", "_rng")

    def __init__(self, name, labels, switch, maxlen: int = 100_000):
        super().__init__(name, labels, switch)
        self._samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._maxlen = int(maxlen)
        self._rng = random.Random(0)

    def observe(self, v: float) -> None:
        if not self._switch.on:
            return
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if len(self._samples) < self._maxlen:
                self._samples.append(v)
            else:  # reservoir replacement keeps percentiles representative
                self._samples[self._rng.randrange(self._maxlen)] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """Exact percentile (linear interpolation) over retained samples."""
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return math.nan
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> Dict[str, float]:
        with self._lock:
            n = self.count
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create registry of instruments keyed by (name, labels)."""

    def __init__(self, switch: Optional[Switch] = None):
        self.switch = switch if switch is not None else Switch(True)
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, Tuple[Tuple[str, str], ...]], _Instrument] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict[str, str], **kw):
        key = (kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[2], self.switch, **kw)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, maxlen: int = 100_000, **labels: str) -> Histogram:
        return self._get("histogram", Histogram, name, labels, maxlen=maxlen)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._metrics.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict view: counters/gauges -> value, histograms -> summary."""
        out: Dict[str, object] = {}
        for m in self.instruments():
            if isinstance(m, Histogram):
                out[m.full_name] = m.summary()
            else:
                out[m.full_name] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (counters, gauges, summaries)."""
        lines: List[str] = []
        seen_types = set()
        for m in sorted(self.instruments(), key=lambda m: m.full_name):
            pname = m.name.replace(".", "_").replace("-", "_")
            lbl = _format_labels(m.labels)
            if isinstance(m, Counter):
                if pname not in seen_types:
                    lines.append("# TYPE %s counter" % pname)
                    seen_types.add(pname)
                lines.append("%s%s %g" % (pname, lbl, m.value))
            elif isinstance(m, Gauge):
                if pname not in seen_types:
                    lines.append("# TYPE %s gauge" % pname)
                    seen_types.add(pname)
                lines.append("%s%s %g" % (pname, lbl, m.value))
            elif isinstance(m, Histogram):
                if pname not in seen_types:
                    lines.append("# TYPE %s summary" % pname)
                    seen_types.add(pname)
                s = m.summary()
                base = list(m.labels)
                for q in (50, 95, 99):
                    qlbl = _format_labels(tuple(base + [("quantile", "0.%02d" % q)]))
                    lines.append("%s%s %g" % (pname, qlbl, s.get("p%d" % q, math.nan)))
                lines.append("%s_sum%s %g" % (pname, lbl, m.total))
                lines.append("%s_count%s %d" % (pname, lbl, m.count))
        return "\n".join(lines) + ("\n" if lines else "")


#: Global registry, gated on :data:`GLOBAL_SWITCH` (off by default).
REGISTRY = MetricsRegistry(GLOBAL_SWITCH)
