"""What the profiler adds to a round, in %: the profiled rounds' wall time
a round (the span of their ``bench.round`` ranges) over the untraced
window's ``round_ms``, less one.  The traced run's idle share and layer
times carry this cost, most where the host dispatches many small
launches; read them beside it."""


def read(ctx):
    if not ctx.get("round_ms") or not ctx.get("rounds") \
            or ctx["t1"] <= ctx["t0"]:
        return None
    traced_ms = (ctx["t1"] - ctx["t0"]) / ctx["rounds"] * 1e3
    return 100.0 * (traced_ms / ctx["round_ms"] - 1.0)
