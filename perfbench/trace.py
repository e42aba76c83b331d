"""A ``torch.profiler`` trace as the per-layer readers see it.

The harness exports the profiled rounds as a Chrome trace and reads back:
the device's operations (kernels, copies, sets), the host's launches (the
CUDA API calls that enqueue them, tied to each by the correlation id),
the host operators that made them (tied by the external id), and the
benchmark's own ranges (``bench.*`` record_function ranges, opened around
each profiled round and the calls into the program's layers).  A kernel
belongs to a range when its launch lies inside it.  Times are seconds."""
from __future__ import annotations

import bisect
import collections
import json

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_HOST = ("cpu_op", "user_annotation")


class Spans:
    """Non-overlapping (start, end, name) intervals, looked up by time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self._starts = [s[0] for s in self.spans]

    def at(self, t: float):
        """The name of the span holding ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i][2]
        return None


class Trace:
    """The events of one Chrome trace, indexed."""

    def __init__(self, events: list):
        self.kernels = []        # (start, end, name, correlation)
        self.device = []         # (start, end, correlation) of every
        #                          device operation
        self.launches = {}       # correlation -> (host time, external id)
        self.host_names = {}     # external id -> host operator's name
        self.ranges = collections.defaultdict(list)   # name -> [(s, e)]
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat"), e.get("args") or {}
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
            if cat in _DEVICE:
                self.device.append((t0, t1, args.get("correlation")))
                if cat == "kernel":
                    self.kernels.append((t0, t1, e["name"],
                                         args.get("correlation")))
            elif cat in _LAUNCH and "correlation" in args:
                self.launches[args["correlation"]] = (
                    t0, args.get("External id"))
            elif cat in _HOST:
                if "External id" in args:
                    self.host_names[args["External id"]] = e["name"]
                if cat == "user_annotation" and \
                        e["name"].startswith("bench."):
                    self.ranges[e["name"]].append((t0, t1))
        self.kernels.sort()
        self.device.sort()

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def spans(self, prefix: str) -> Spans:
        """Every ``bench.`` range whose name starts with ``prefix``."""
        return Spans([(s, e, name) for name, iv in self.ranges.items()
                      if name.startswith(prefix) for s, e in iv])

    def window(self, name: str = "bench.round"):
        """(start, end, count) of the ranges called ``name``."""
        iv = self.ranges.get(name, [])
        if not iv:
            return None
        return min(s for s, _ in iv), max(e for _, e in iv), len(iv)

    def launch_of(self, kernel):
        """(host time, external id) of a kernel's launch, or None."""
        return self.launches.get(kernel[3])

    def by_range(self, prefix: str) -> list:
        """(kernel, the name of its ``prefix`` range or None) for every
        kernel."""
        spans = self.spans(prefix)
        out = []
        for k in self.kernels:
            launch = self.launch_of(k)
            out.append((k, None if launch is None else spans.at(launch[0])))
        return out

    def busy_intervals(self, t0: float, t1: float) -> list:
        """The union of the device operations, clipped to [t0, t1]."""
        merged = []
        for s, e, _ in self.device:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def idle_gaps(self, t0: float, t1: float) -> dict:
        """Idle seconds in [t0, t1] by what the host was preparing: each
        gap goes to the host operator that launched the device operation
        ending it (with the ``bench.layer.`` range the launch lies in)."""
        busy = self.busy_intervals(t0, t1)
        starts = [d[0] for d in self.device]
        layers = self.spans("bench.layer.")
        out = collections.defaultdict(float)
        prev = t0
        for s, e in busy + [[t1, t1]]:
            if s > prev:
                i = bisect.bisect_left(starts, s)
                name = "end of window"
                if s < t1 and i < len(self.device):
                    launch = self.launches.get(self.device[i][2])
                    name = "unknown launch"
                    if launch is not None:
                        op = self.host_names.get(launch[1], "launch")
                        layer = layers.at(launch[0]) or "bench.round"
                        name = f"{layer[len('bench.'):]}:{op}"
                out[name] += s - prev
            prev = max(prev, e)
        return dict(out)
