"""The share of the profiled rounds, in %, in which no operation ran on
the device: one less the union of the device's operations over the span
of the ``bench.round`` ranges."""


def read(ctx):
    t0, t1 = ctx["t0"], ctx["t1"]
    busy = sum(e - s for s, e in ctx["trace"].busy_intervals(t0, t1))
    if busy <= 0.0 or t1 <= t0:
        return None
    return 100.0 * (1.0 - busy / (t1 - t0))
