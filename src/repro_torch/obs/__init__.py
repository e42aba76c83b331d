"""repro_torch.obs — spans, metrics, and the predicted-vs-measured drift ledger.

Off by default and inert: until :func:`enable` flips the global switch,
every ``trace.span`` returns a shared no-op context manager, every
global-registry instrument drops its sample after one attribute check, and
enabling it leaves Plan / RunReport (apart from wall time) / FaultTrace
identical (asserted for the port by ``tests/test_torch_sampling.py`` and
``tests/test_torch_faults.py``, and on the card by ``chip_smoke.py``).

Quickstart::

    from repro_torch import obs
    obs.enable()
    with obs.trace.span("my.block", note="warm"):
        report = scenario.run(plan, backend="reference", seed=0)
    print(report.drift().summary())          # per-round drift ledger
    print(obs.REGISTRY.to_prometheus())      # metrics text dump
    obs.trace.save("results/obs/trace.json") # open at ui.perfetto.dev

Instrumented call sites record only at host boundaries (``Scenario``'s
optimize and run spans, the reference runtime's round loop,
``FaultDriver.step``) and read the host clock without synchronizing the
card, so observing adds no device work and no wait; with obs on,
``Scenario.run`` also writes the run's drift ledger under
:func:`artifact_dir`.
"""
from __future__ import annotations

import os

from . import bench, trace
from .bench import write_bench
from .ledger import LedgerRow, RunLedger
from .metrics import (GLOBAL_SWITCH, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, Switch)
from .trace import TRACER, Tracer, span

__all__ = [
    "enable", "disable", "enabled", "artifact_dir", "artifact_path",
    "trace", "span", "TRACER", "Tracer",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram", "Switch",
    "RunLedger", "LedgerRow",
    "bench", "write_bench",
]


def enable(reset: bool = False) -> None:
    """Turn on the global tracer + metrics registry (off by default)."""
    if reset:
        TRACER.clear()
        REGISTRY.reset()
    GLOBAL_SWITCH.on = True


def disable() -> None:
    """Turn observability back off (buffers are kept until ``enable(reset=True)``)."""
    GLOBAL_SWITCH.on = False


def enabled() -> bool:
    return GLOBAL_SWITCH.on


def artifact_dir() -> str:
    """Where run artifacts (ledgers, traces) land; override with REPRO_OBS_DIR."""
    return os.environ.get("REPRO_OBS_DIR", os.path.join("results", "obs"))


def artifact_path(name: str) -> str:
    d = artifact_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)
