"""Span tracer with Chrome-trace / Perfetto JSON export.

Spans are recorded only at natural host boundaries (function entry/exit on the
Python side of a dispatch, queue hand-offs, resolution callbacks) — never from
inside traced JAX code — so enabling tracing adds **zero extra compiles and
zero host syncs** to jitted ``lax.while_loop`` paths.

The tracer buffers events in a bounded deque under a lock; when the shared
:class:`~repro.obs.metrics.Switch` is off, ``span()`` hands back a shared no-op
context manager and nothing is buffered.

Export target is the Chrome trace-event JSON format, which Perfetto
(https://ui.perfetto.dev) opens directly:

* ``span()`` / ``add_span()`` emit complete events (``"ph": "X"``) with
  microsecond ``ts``/``dur`` relative to the tracer epoch.
* ``async_span()`` emits ``"b"``/``"e"`` async pairs so overlapping
  per-request lifetimes (e.g. PlanServer queue→solve) each render on their
  own track instead of stacking incorrectly on one thread lane.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .metrics import GLOBAL_SWITCH, Switch


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.add_span(self.name, self._t0, time.perf_counter(), **self.args)
        return False


class Tracer:
    """Thread-safe, bounded buffer of Chrome trace events."""

    def __init__(self, switch: Optional[Switch] = None, maxlen: int = 200_000):
        self.switch = switch if switch is not None else Switch(True)
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=maxlen)
        self._epoch = time.perf_counter()
        self._pid = os.getpid()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **args: object):
        """Context manager timing a host-side region; no-op when disabled."""
        if not self.switch.on:
            return _NOOP
        return _Span(self, name, args)

    def add_span(self, name: str, t_start: float, t_end: float, **args: object) -> None:
        """Record a completed span from ``time.perf_counter()`` endpoints.

        Lets callers stamp timestamps as events happen but defer buffering to
        a natural host point (PlanServer records queue spans at resolution).
        """
        if not self.switch.on:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t_start - self._epoch) * 1e6,
            "dur": max(0.0, (t_end - t_start) * 1e6),
            "pid": self._pid,
            "tid": threading.get_ident() % 2**31,
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    def async_span(self, name: str, span_id: int, t_start: float, t_end: float,
                   cat: str = "async", **args: object) -> None:
        """Record a begin/end async pair (own track per ``span_id`` in Perfetto)."""
        if not self.switch.on:
            return
        common = {"name": name, "cat": cat, "id": int(span_id) % 2**31,
                  "pid": self._pid, "tid": threading.get_ident() % 2**31}
        b = dict(common, ph="b", ts=(t_start - self._epoch) * 1e6)
        e = dict(common, ph="e", ts=(t_end - self._epoch) * 1e6)
        if args:
            b["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(b)
            self._events.append(e)

    def instant(self, name: str, **args: object) -> None:
        if not self.switch.on:
            return
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter() - self._epoch) * 1e6,
            "pid": self._pid,
            "tid": threading.get_ident() % 2**31,
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    # -- inspection / export ----------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> dict:
        """Chrome trace-event document; open at https://ui.perfetto.dev."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        doc = self.to_chrome()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _jsonable(v: object) -> object:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


#: Global tracer, gated on the process-wide switch (off by default).
TRACER = Tracer(GLOBAL_SWITCH)


def span(name: str, **args: object):
    """``with trace.span("gia.solve", sig=...):`` on the global tracer."""
    return TRACER.span(name, **args)


def device_range(name: str):
    """``with trace.device_range("moe.route"):`` names the operations inside
    for a running ``torch.profiler`` (a ``record_function`` range: its host
    event sums the device time of the kernels launched inside it); with no
    profiler running it does nothing."""
    import torch
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def add_span(name: str, t_start: float, t_end: float, **args: object) -> None:
    TRACER.add_span(name, t_start, t_end, **args)


def async_span(name: str, span_id: int, t_start: float, t_end: float, **args: object) -> None:
    TRACER.async_span(name, span_id, t_start, t_end, **args)


def instant(name: str, **args: object) -> None:
    TRACER.instant(name, **args)


def save(path: str) -> str:
    return TRACER.save(path)
