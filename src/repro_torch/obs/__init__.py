"""repro_torch.obs — spans, metrics, and the predicted-vs-measured drift ledger.

Off by default and provably inert: until :func:`enable` flips the global
switch, every ``trace.span`` returns a shared no-op context manager, every
global-registry instrument drops its sample after one attribute check, and
enabling it leaves Plan / RunReport / FaultTrace **bit-identical** (asserted
by ``tests/unit/test_obs.py`` and hard-gated, with <2% overhead, by
``benchmarks/obs_bench.py``).

Quickstart::

    from repro_torch import obs
    obs.enable()
    with obs.trace.span("my.block", note="warm"):
        report = scenario.run(plan, backend="reference", seed=0)
    print(report.drift().summary())          # per-round drift ledger
    print(obs.REGISTRY.to_prometheus())      # metrics text dump
    obs.trace.save("results/obs/trace.json") # open at ui.perfetto.dev

Instrumented call sites record only at natural host boundaries (dispatch
wrappers, queue hand-offs, resolution callbacks) — never inside traced JAX
code — so jitted ``lax.while_loop`` paths gain zero extra compiles and zero
host syncs (asserted via the ``TRACE_COUNTS`` hook in ``repro.opt.gia_jax``).
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
