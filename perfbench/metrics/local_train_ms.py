"""Device time a round, in ms, of the kernels launched inside the
benchmark's ``bench.layer.local_train`` ranges (the round's calls into
``repro_torch.fed.runtime.local_train``: every worker's local steps)."""


def read(ctx):
    hits = [k for k, r in ctx["trace"].by_range("bench.layer.")
            if r == "bench.layer.local_train"]
    if not hits:
        return None
    return sum(e - s for s, e, _, _ in hits) / ctx["rounds"] * 1e3
