"""CUDA kernel records a round in the profiled rounds: the host's
dispatch count (every eager operator launches at least one)."""


def read(ctx):
    t0, t1 = ctx["t0"], ctx["t1"]
    n = sum(1 for s, _, _, _ in ctx["trace"].kernels if t0 <= s <= t1)
    return n / ctx["rounds"] if n else None
