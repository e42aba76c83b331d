"""Render the dry-run and roofline tables (``repro/roofline/report.py``)
from the port's results JSON.

    PYTHONPATH=src python -m repro_torch.roofline.report
"""
from __future__ import annotations

import json

__all__ = ["dryrun_table", "roofline_table"]


def _gib(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(path="results/torch/dryrun/summary.json") -> str:
    with open(path) as f:
        rs = json.load(f)
    lines = ["| arch | shape | mesh | fl | count s | args GiB/dev"
             " | out GiB/dev | fits | GFLOP/dev | coll MiB/dev | status |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"| | | | | | | {r['status']}: "
                         f"{r.get('reason', r.get('error', ''))[:70]} |")
            continue
        m = r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['fl_axis']} | "
            f"{r['count_s']} | {_gib(m['argument_bytes'])} | "
            f"{_gib(m['output_bytes'])} | {'yes' if r['fits'] else 'no'} | "
            f"{r['cost'].get('flops', 0)/1e9:.1f} | "
            f"{r['collectives']['total_bytes']/2**20:.0f} | ok |")
    return "\n".join(lines)


def roofline_table(path="results/torch/roofline/summary.json") -> str:
    with open(path) as f:
        rs = json.load(f)
    lines = ["| arch | shape | chips | compute s | memory s | collective s |"
             " dominant | MODEL_FLOPS | counted FLOPs | useful ratio |"
             " next move |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | | | | | "
                         f"{r['status']} | | | | "
                         f"{r.get('reason', r.get('error', ''))[:60]} |")
            continue
        t = r["terms"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['chips']} | "
            f"{t['compute_s']:.3g} | {t['memory_s']:.3g} | "
            f"{t['collective_s']:.3g} | **{t['dominant']}** | "
            f"{r['model_flops']:.3g} | {r['flops_counted']:.3g} | "
            f"{r['useful_flops_ratio']:.2f} | {r['hint'][:58]} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print("## Dry-run\n")
    print(dryrun_table())
    print("\n## Roofline\n")
    print(roofline_table())
