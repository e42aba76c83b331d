"""Dry-run: every (arch × input-shape) case built and run on fake tensors,
its bytes held against one card (``repro/launch/dryrun.py``).

``repro`` lowers and compiles each case on a 512-device XLA host mesh and
reads ``memory_analysis()``; here :func:`~repro_torch.launch.specs.
build_case` makes the case's arguments as fake tensors (nothing
allocated) and :func:`~repro_torch.launch.roofline.count_case` runs its
step on them:

- ``memory.argument_bytes``: every argument's bytes (weights, batch or
  caches, the host's key words), exact;
- ``memory.output_bytes``: the outputs the step allocates (decode's
  caches are updated in place and not counted again), exact;
- ``memory.temp_bytes``: null — activations, gradients and the bf16 view
  the round makes are not reckoned, so ``total_per_device_gib`` and
  ``fits`` (argument + output bytes within one card) are a floor;
- ``cost.flops``: the step's counted FLOPs (see ``launch/roofline.py``;
  a training round's are one local step's times fl·K_max, ``counted``);
- ``collectives.total_bytes``: 0, one card.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results/torch/dryrun]
"""
import argparse
import json
import os
import time
import traceback

#: one H100 80GB HBM3's memory as ``torch.cuda.get_device_properties(0).
#: total_memory`` reports it (``chip_smoke.py``'s launch phase prints it)
H100_80GB_BYTES = 85_017_493_504


def card_bytes() -> tuple:
    """(name, bytes) of the card a case must fit: the CUDA card where one
    is present, else the H100 80GB HBM3's figure."""
    import torch
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.name, int(props.total_memory)
    return "NVIDIA H100 80GB HBM3", H100_80GB_BYTES


def run_case(arch: str, shape_name: str, wire: str = "f32",
             verbose: bool = True, smoke: bool = False) -> dict:
    from ..configs.base import INPUT_SHAPES
    from ..launch.roofline import count_case
    from ..launch.specs import case_supported
    from ..models.registry import get_config

    cfg = get_config(arch, smoke=smoke)
    shape = INPUT_SHAPES[shape_name]
    reason = case_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": "h100x1", "wire": wire}
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    t0 = time.time()
    c = count_case(arch, shape_name, cfg, wire=wire)
    t_count = time.time() - t0
    args_b, out_b = c["argument_bytes"], c["output_bytes"]
    card, cap = card_bytes()
    case = c["case"]
    rec.update({
        "status": "ok",
        "count_s": round(t_count, 2),
        "depth": c["depth"],
        "counted": c["counted"],
        "memory": {
            "argument_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": None,
            "total_per_device_gib": round((args_b + out_b) / 2**30, 3),
        },
        "card": card,
        "card_bytes": cap,
        "fits": args_b + out_b <= cap,
        "cost": {"flops": c["flops"]},
        "collectives": {"total_bytes": 0},
        "fl_axis": case.fed.n_workers if case.fed else 1,
        "param_count": cfg.param_count(),
        "param_count_active": cfg.param_count(active_only=True),
    })
    if verbose:
        m = rec["memory"]
        print(f"  count {t_count:.1f}s | args {m['argument_bytes']/2**30:.2f}"
              f" GiB out {m['output_bytes']/2**30:.2f} GiB "
              f"({'fits' if rec['fits'] else 'does not fit'} {card}) | "
              f"flops {rec['cost']['flops']:.3g}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--wire", default="f32", choices=["f32", "int8"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun")
    args = ap.parse_args(argv)

    from ..configs.base import INPUT_SHAPES
    from ..models.registry import ARCH_IDS

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape is None)
              else [args.shape])

    os.makedirs(args.out, exist_ok=True)
    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            print(f"[dryrun] {arch} x {shape}", flush=True)
            try:
                rec = run_case(arch, shape, wire=args.wire)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": "h100x1",
                       "status": "FAILED",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            if rec["status"] == "skipped":
                print(f"  skipped: {rec['reason']}", flush=True)
            results.append(rec)
            fname = f"{arch.replace('/', '_')}_{shape}.json"
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(rec, f, indent=2)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n[dryrun] ok={n_ok} skipped={n_skip} failed={failures} "
          f"-> {args.out}/summary.json")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
