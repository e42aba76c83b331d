"""Device time a round, in ms, of the kernels launched inside the
benchmark's ``bench.layer.aggregate_apply`` ranges (the round's call into
``repro_torch.fed.runtime.aggregate_apply``: noise, encode, the wire,
decode and the server's quantize and apply)."""


def read(ctx):
    hits = [k for k, r in ctx["trace"].by_range("bench.layer.")
            if r == "bench.layer.aggregate_apply"]
    if not hits:
        return None
    return sum(e - s for s, e, _, _ in hits) / ctx["rounds"] * 1e3
