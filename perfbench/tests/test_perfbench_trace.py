"""The trace reading and the per-layer readers on a hand-made Chrome trace:
kernels tied to the benchmark's ranges through their launches, the busy
and idle time, and each reader's number worked out by hand."""
import pytest

from perfbench import manifest
from perfbench.roofline import H100, qsgd_bytes
from perfbench.trace import Trace

US = 1e-6


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _events():
    """Two profiled rounds of 1,000 us: local training launches two
    kernels, the aggregate one K2 launch (its range names its shape) and
    an elementwise kernel; the device idles between them."""
    ev = []
    corr = iter(range(1, 100))
    for r in range(2):
        t = 1000.0 * r
        ev.append(_x("user_annotation", "bench.round", t, 1000.0,
                     **{"External id": 10 * r + 1}))
        ev.append(_x("user_annotation", "bench.layer.local_train", t + 10,
                     400.0, **{"External id": 10 * r + 2}))
        ev.append(_x("user_annotation", "bench.layer.aggregate_apply",
                     t + 500, 400.0, **{"External id": 10 * r + 3}))
        ev.append(_x("user_annotation", "bench.kernel.qsgd_quantize:2:1000:1",
                     t + 600, 50.0, **{"External id": 10 * r + 4}))
        ev.append(_x("cpu_op", "aten::mm", t + 20, 5.0,
                     **{"External id": 10 * r + 5}))
        launches = [(t + 20, t + 100, 200.0, "gemm", 10 * r + 5),
                    (t + 30, t + 300, 100.0, "gemm", 10 * r + 5),
                    (t + 610, t + 620, 40.0,
                     "void (anonymous namespace)::quantize_kernel<signed "
                     "char>(float const*)", 10 * r + 4),
                    (t + 700, t + 800, 50.0, "elementwise", None)]
        for host, start, dur, name, ext in launches:
            c = next(corr)
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", host, 2.0,
                         correlation=c, **{"External id": ext}))
            ev.append(_x("kernel", name, start, dur, correlation=c))
    ev.append(_x("gpu_memset", "Memset", 950.0, 10.0))
    ev.append({"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1.0})
    return ev


@pytest.fixture(scope="module")
def ctx():
    tr = Trace(_events())
    t0, t1, rounds = tr.window("bench.round")
    return {"trace": tr, "t0": t0, "t1": t1, "rounds": rounds,
            "round_ms": 4.0, "flops_per_round": 989e12 * 4e-3 * 0.25}


def test_window_and_ranges(ctx):
    tr = ctx["trace"]
    assert tr.window("bench.round") == (0.0, 2000.0 * US, 2)
    by = dict(((k[2][:4], k[0]), r) for k, r in tr.by_range("bench.layer."))
    assert by[("gemm", 100 * US)] == "bench.layer.local_train"
    assert by[("elem", 800 * US)] == "bench.layer.aggregate_apply"


def test_busy_and_idle(ctx):
    tr = ctx["trace"]
    busy = sum(e - s for s, e in tr.busy_intervals(0.0, 2000 * US))
    # each round: gemm 100-300 and 300-400, K2 620-660, elementwise 800-850;
    # the first round's memset 950-960
    assert busy == pytest.approx((300 + 40 + 50) * 2 * US + 10 * US)
    gaps = tr.idle_gaps(0.0, 2000 * US)
    assert sum(gaps.values()) == pytest.approx(2000 * US - busy)
    # the gemm that starts each round ends a gap of 100 and of 140 us; the
    # memset, whose launch the trace lacks, one of 100
    assert gaps["layer.local_train:aten::mm"] == pytest.approx(240 * US)
    assert gaps["unknown launch"] == pytest.approx(100 * US)


@pytest.mark.parametrize("metric,want", [
    ("local_train_ms", 0.3),
    ("aggregate_ms", 0.09),
    ("kernels_per_round", 4.0),
    ("mfu.train", 25.0),
    ("idle_share.train", 100 * (1 - (780 + 10) / 2000)),
    ("trace_overhead.train", 100 * (1.0 / 4.0 - 1.0)),
    ("qsgd_roofline",
     100 * qsgd_bytes("qsgd_quantize", 2, 1000, 1) / H100["hbm_bytes"]
     / (40 * US)),
])
def test_readers(ctx, metric, want):
    assert manifest.reader(metric)(ctx) == pytest.approx(want)


def test_readers_find_nothing_in_an_empty_trace():
    tr = Trace([_x("user_annotation", "bench.round", 0.0, 100.0)])
    ctx = {"trace": tr, "t0": 0.0, "t1": 1e-4, "rounds": 1}
    for m in ("local_train_ms", "aggregate_ms", "qsgd_roofline",
              "kernels_per_round", "mfu.train", "idle_share.train",
              "trace_overhead.train"):
        assert manifest.reader(m)(ctx) is None, m
