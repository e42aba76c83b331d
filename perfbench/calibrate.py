"""Readings that a training cell's correctness limits are set from, many
seeds in one process (no window: the check reads only the first rounds):

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --runs sound=12,control=3,half_batch=3 [--device cuda] [--out F]

For each seed the plain reference follows the cell's checked rounds once;
then each listed run of the program follows them too, for the first N
seeds its count gives: ``sound`` as the cell states it, ``control`` with
the program's bf16 master weights, and each fault of
``perfbench/faults.py``.  Each run's numbers (the ones the check compares)
print as one JSON line; ``--out`` also keeps every reading."""
import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                     "src")]


def calibrate(spec: dict, seeds: list, runs: dict, device) -> list:
    """The readings of each run of ``runs`` (name -> seeds it takes) on the
    cell ``spec``, one record a (seed, run)."""
    import torch
    from perfbench import faults, manifest
    from perfbench.inputs import param_spec
    from perfbench.reference.tree import leaves
    drv = manifest.runner(spec["traffic"]["runner"])
    n_leaves = len(leaves(param_spec(spec["config"])))
    master = drv.DTYPES[spec["config"]["precision"]["master"]]
    rounds = spec["job"]["check_rounds"]
    records = []
    for i, seed in enumerate(seeds):
        t = time.time()
        ref = drv.reference(spec, seed, device, rounds)
        t_ref = time.time() - t
        drv.release(device)
        for run, count in runs.items():
            if i >= count:
                continue
            t = time.time()
            dtype = torch.bfloat16 if run == "control" else master
            plant = faults.FAULTS[run](n_leaves) if run in faults.FAULTS \
                else contextlib.nullcontext()
            with plant:
                prog = drv.Program(spec, seed, device, dtype)
                got = prog.check_rounds(rounds)
            del prog
            drv.release(device)
            checks = drv.compare(got, ref, spec["job"]["limits"])
            rec = {"workload": spec["name"], "seed": seed, "run": run,
                   **{k: c["value"] for k, c in checks.items()},
                   "program_s": time.time() - t, "reference_s": t_ref}
            print(json.dumps(rec), flush=True)
            records.append(dict(rec, program=got, reference=ref))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--runs", default="sound=12,control=3")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench import manifest
    records = calibrate(
        manifest.cell(manifest.load(), args.workload),
        [int(s) for s in args.seeds.split(",")],
        {k: int(v) for k, v in (kv.split("=")
                                for kv in args.runs.split(","))},
        args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f)


if __name__ == "__main__":
    main()
