"""Roofline extraction for every supported (arch × shape) on one H100
(``repro/launch/roofline.py``).

Methodology: a case's step (:func:`repro_torch.launch.specs.build_case`)
runs on fake tensors under ``FlopCounterMode`` (:meth:`Case.count`):

- FLOPs are those of every matmul, convolution and attention product the
  step dispatches (elementwise work is not counted);
- bytes are the argument bytes plus the bytes of the outputs the step
  allocates: each weight and cache read once, each new output written
  once;
- collective bytes are 0: one card.

Fake tensors run every layer (XLA's ``cost_analysis`` counts a scan body
once; here nothing is scanned), so the full depth needs no extrapolation
for correctness, only for speed: the fake mode dispatches each op of each
layer in Python.  So a stack of R > 2 repeats of its layer pattern is
counted at 1 and 2 repeats and extrapolated, total = c(1) + (R - 1)(c(2)
- c(1)), plus c(1 repeat + tail) - c(1) where n_layers is not a whole
number of patterns (gemma3-4b: 34 layers of a 6-layer pattern).  Every
layer is counted once and layers do not interact in either count, so this
is the full-depth count exactly (``tests/test_torch_roofline.py`` holds
them equal).  An encoder-decoder is cut in both stacks together.  What
stays slow is a loop over time: xlstm's sLSTM dispatches its step once a
token, 4,096 or 32,768 times a layer.

Training cases are built with k_local=1 and microbatch=1, as ``repro``
lowers them: the round's fl workers then run K_max = 2 local steps each
when fl > 1 (Kn alternates 1, 2; the virtual step is computed and moved by
0, as the reference).  Those fl·K_max passes are alike in shape, so one is
run and multiplied (``counted: "local step"``, :meth:`Case.count`), which
``tests/test_torch_roofline.py`` holds equal to running the whole round.

Usage:
  python -m repro_torch.launch.roofline --all [--out results/torch/roofline]
  python -m repro_torch.launch.roofline --arch llama3-405b --shape train_4k
"""
import argparse
import dataclasses
import json
import os
import time
import traceback


def _truncate(cfg, reps: int, tail: int = 0):
    if cfg.encdec:
        return dataclasses.replace(cfg, n_layers=reps, enc_layers=reps)
    return dataclasses.replace(cfg, n_layers=reps * len(cfg.pattern) + tail)


def count_case(arch: str, shape_name: str, cfg, **case_kw) -> dict:
    """FLOPs and bytes of ``build_case(arch, shape_name, cfg_override=cfg,
    **case_kw)``'s step at ``cfg``'s full depth (:meth:`Case.count`) ->
    ``{"flops", "argument_bytes", "output_bytes", "counted", "repeats",
    "depth", "case"}`` (``case`` the full-depth case, never run)."""
    from ..launch.specs import build_case
    from ..roofline.analysis import extrapolate

    case = build_case(arch, shape_name, cfg_override=cfg, **case_kw)
    P = 1 if cfg.encdec else len(cfg.pattern)
    R, tail = divmod(cfg.n_layers, P)
    cut = R > 2 and (not cfg.encdec or cfg.enc_layers == cfg.n_layers)
    if not cut:
        counts, depth = case.count(), "full"
    else:
        def run(reps, t=0):
            return build_case(arch, shape_name,
                              cfg_override=_truncate(cfg, reps, t),
                              **case_kw).count()
        c1, c2 = run(1), run(2)
        keys = ("flops", "output_bytes")
        counts = extrapolate({k: c1[k] for k in keys},
                             {k: c2[k] for k in keys}, R)
        if tail:
            ct = run(1, tail)
            counts = {k: counts[k] + ct[k] - c1[k] for k in keys}
        counts["counted"] = c1["counted"]
        depth = "1 and 2 repeats, extrapolated" + (
            f" (+ a {tail}-layer tail)" if tail else "")
    return {"flops": float(counts["flops"]),
            "argument_bytes": case.argument_bytes(),
            "output_bytes": int(round(counts["output_bytes"])),
            "counted": counts["counted"], "repeats": cfg.n_layers / P,
            "depth": depth, "case": case}


HINTS = {
    "compute": "increase arithmetic efficiency (fuse/quantize compute or "
               "reduce remat recompute)",
    "memory": "reduce bytes touched per step (bf16/int8 operands, fuse "
              "elementwise chains, larger tiles)",
    "collective": "cut wire bytes (int8 QSGD wire, reduce-scatter "
                  "decomposition, rarer syncs / larger K_n)",
}


def roofline_case(arch: str, shape_name: str, smoke: bool = False) -> dict:
    from ..configs.base import INPUT_SHAPES
    from ..launch.specs import case_supported
    from ..models.registry import get_config
    from ..roofline.analysis import H100, roofline_terms

    cfg = get_config(arch, smoke=smoke)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "h100x1"}
    reason = case_supported(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    c = count_case(arch, shape_name, cfg, k_local=1, microbatch=1)
    case = c["case"]
    full = {"flops": c["flops"],
            "bytes_accessed": float(c["argument_bytes"] + c["output_bytes"]),
            "collective_bytes": 0.0}
    # tokens processed by one step execution (k_local=1 for train cases)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.param_count(active_only=True)
    mf_coef = 6.0 if shape.kind == "train" else 2.0
    model_flops = mf_coef * n_active * tokens
    terms = roofline_terms(full["flops"], full["bytes_accessed"],
                           full["collective_bytes"], chips=1, hw=H100)
    rec.update({
        "status": "ok",
        "dt": round(time.time() - t0, 1),
        "repeats": c["repeats"],
        "depth": c["depth"],
        "counted": c["counted"],
        "chips": 1,
        "per_device": full,
        "terms": terms,
        "model_flops": model_flops,
        "flops_counted": full["flops"],
        "useful_flops_ratio": model_flops / max(full["flops"], 1.0),
        "fl_axis": case.fed.n_workers if case.fed else 1,
        "hint": HINTS[terms["dominant"]],
    })
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch/roofline")
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
            print(f"[roofline] {arch} x {shape}", flush=True)
            try:
                rec = roofline_case(arch, shape)
                if rec["status"] == "ok":
                    t = rec["terms"]
                    print(f"  compute={t['compute_s']*1e3:.2f}ms "
                          f"memory={t['memory_s']*1e3:.2f}ms "
                          f"collective={t['collective_s']*1e3:.2f}ms "
                          f"dominant={t['dominant']} "
                          f"useful={rec['useful_flops_ratio']:.2f}",
                          flush=True)
                else:
                    print(f"  skipped: {rec['reason']}", flush=True)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "status": "FAILED",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            results.append(rec)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"\n[roofline] done: {sum(r['status']=='ok' for r in results)} ok, "
          f"{failures} failed -> {args.out}/summary.json")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
