"""Run one cell of the port's benchmark, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It needs the port's package beside it (``src/repro_torch``) and as many
CUDA cards as the cell asks for; without them it exits with a code other
than 0 and prints no result.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, traced ``breakdown``, ``conditions`` (the
host's and the card's state over the window, no metric); last, ``checks``,
each number the correctness check compared with its limit, which also
end standard error.  A run that has loaded ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` exits with a code other than 0 and no result.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _setup_paths():
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        sys.exit(f"perfbench: the port's package is not in this checkout "
                 f"({src}/repro_torch)")
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.path[:0] = [ROOT, src]


def layer_metrics(manifest: dict, name: str, ctx: dict) -> tuple:
    """Each per-layer metric of cell ``name`` that its reader finds, the
    device's busy and traced seconds, and the breakdown."""
    from perfbench import manifest as M
    tr = ctx["trace"]
    window = tr.window("bench.round")
    if window is None:
        raise RuntimeError("the trace holds no bench.round range")
    t0, t1, rounds = window
    ctx = dict(ctx, rounds=rounds, t0=t0, t1=t1)
    metrics = {}
    for m in M.metrics_of(manifest, "per_layer", name):
        value = M.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = sum(e - s for s, e in tr.busy_intervals(t0, t1))
    by_kernel = {}
    for s, e, kname, _ in tr.kernels:
        if t0 <= s <= t1:
            by_kernel[kname[:120]] = by_kernel.get(kname[:120], 0.0) + e - s
    gaps = tr.idle_gaps(t0, t1)
    breakdown = {
        "device_ops": [[k, v] for k, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:10]]}
    return metrics, busy, t1 - t0, breakdown


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()
    from perfbench import manifest as M
    manifest = M.load(ROOT)
    spec = M.cell(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"perfbench: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    runner = M.runner(spec["traffic"]["runner"])
    out = runner.run(spec, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        metrics, busy, window, breakdown = layer_metrics(
            manifest, args.workload, out["trace"])
        device.update(busy_s=busy, window_s=window)
    else:
        metrics = {m["name"]: {"value": out["values"][m["name"]],
                               "unit": m["unit"]}
                   for m in M.metrics_of(manifest, "end_to_end",
                                         args.workload)}
    result.update(metrics=metrics, device=device)
    if args.trace:
        result["breakdown"] = breakdown
    result["conditions"] = out["conditions"]
    result["checks"] = out["checks"]
    leaked = forbidden_modules()
    if leaked:
        print(f"perfbench: the run loaded {leaked}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
