"""Perf hillclimb driver (``repro/launch/perf.py``): re-extract the
roofline terms (against the H100) for named variants of the three selected
(arch × shape) pairs and append to ``results/torch/perf/log.json``.

Variants are config switches (``--capacity``, ``--window``) or the wire;
each entry records the label, the change and the terms.  ``repro``'s
``--multi`` (the 2-pod mesh) has no counterpart: one card.

Usage: python -m repro_torch.launch.perf --pair llama3_train --wire int8 \\
           --label int8_wire
"""
import argparse
import dataclasses
import json
import os
import time

PAIRS = {
    "llama3_train": ("llama3-405b", "train_4k"),
    "xlstm_prefill": ("xlstm-1.3b", "prefill_32k"),
    "phi35_train": ("phi3.5-moe-42b-a6.6b", "train_4k"),
}


def measure(arch, shape, *, wire="f32", cfg_mutation=None):
    """The roofline terms of ``arch`` × ``shape`` with ``cfg_mutation``
    applied to the config, counted as ``launch/roofline.py`` counts
    (k_local=1, microbatch=1)."""
    from ..launch.roofline import count_case
    from ..models.registry import get_config
    from ..roofline.analysis import H100, roofline_terms

    cfg = get_config(arch)
    if cfg_mutation:
        cfg = dataclasses.replace(cfg, **cfg_mutation)
    c = count_case(arch, shape, cfg, wire=wire, k_local=1, microbatch=1)
    full = {"flops": c["flops"],
            "bytes_accessed": float(c["argument_bytes"] + c["output_bytes"]),
            "collective_bytes": 0.0}
    terms = roofline_terms(full["flops"], full["bytes_accessed"],
                           full["collective_bytes"], chips=1, hw=H100)
    return {"per_device": full, "terms": terms, "depth": c["depth"]}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--pair", choices=list(PAIRS), required=True)
    ap.add_argument("--wire", default="f32")
    ap.add_argument("--label", default="baseline")
    ap.add_argument("--capacity", type=float, default=None)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--out", default="results/torch/perf")
    args = ap.parse_args(argv)

    arch, shape = PAIRS[args.pair]
    mut = {}
    if args.capacity is not None:
        mut["capacity_factor"] = args.capacity
    if args.window is not None:
        mut["window"] = args.window
    t0 = time.time()
    rec = measure(arch, shape, wire=args.wire, cfg_mutation=mut or None)
    rec.update({"pair": args.pair, "label": args.label, "wire": args.wire,
                "mutation": mut, "dt": round(time.time() - t0, 1)})
    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "log.json")
    log = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = json.load(f)
    log.append(rec)
    with open(log_path, "w") as f:
        json.dump(log, f, indent=2)
    t = rec["terms"]
    print(f"[perf] {args.pair} / {args.label}: "
          f"compute={t['compute_s']:.3g}s memory={t['memory_s']:.3g}s "
          f"collective={t['collective_s']:.3g}s dominant={t['dominant']}")
    return rec


if __name__ == "__main__":
    main()
