"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration and its traffic
mix; the harness reads ``configs/<config>.json``, ``traffic/<traffic>.json``
and the cell's job, ``workloads/<cell>.json`` (its sizes and the limits of
its correctness check).  The traffic names the runner of its kind of job,
``runners/<runner>.py``.  Each per-layer metric has its reader,
``metrics/<metric>.py``.  Adding a configuration, a mix, a cell or a metric
adds files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def name_problems(manifest: dict) -> list:
    """Every name, config, traffic, reduced key and unit that breaks the
    naming rules, and every name given twice."""
    bad = []

    def name(where, value):
        if not isinstance(value, str) or not NAME.match(value):
            bad.append(f"{where}: {value!r}")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in manifest.get(kind, ()):
            name(f"{kind} name", e.get("name"))
            if e.get("name") in seen:
                bad.append(f"{kind} name given twice: {e.get('name')!r}")
            seen.add(e.get("name"))
            if kind in ("end_to_end", "per_layer") and (
                    not isinstance(e.get("unit"), str)
                    or not UNIT.match(e["unit"])):
                bad.append(f"{kind} unit: {e.get('unit')!r}")
    for c in manifest.get("configs", ()):
        for key in c.get("reduced", ()):
            name("reduced key", key)
    for w in manifest.get("workloads", ()):
        name("workload config", w.get("config"))
        name("workload traffic", w.get("traffic"))
    return bad


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(manifest: dict, name: str, bench_dir: str = BENCH_DIR) -> dict:
    """The cell ``name``: {"name", "chips", "config", "traffic", "job"},
    each of the last three the parsed file that the manifest's names
    point to."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in manifest['workloads']]}")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    job = _json(bench_dir, "workloads", f"{name}.json")
    for key in ("config", "traffic"):
        if job[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{job[key]!r}, BENCHMARK.json {entry[key]!r}")
    return {"name": name, "chips": entry["chips"],
            "config": _json(os.path.dirname(bench_dir), conf["file"]),
            "traffic": _json(bench_dir, "traffic", f"{entry['traffic']}.json"),
            "job": job}


def metrics_of(manifest: dict, kind: str, cell_name: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell
    ``cell_name`` reports."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", (cell_name,))]


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return _module(os.path.join(bench_dir, "metrics", f"{metric}.py"),
                   f"perfbench_metric_{metric.replace('.', '_')}").read


def runner(name: str, bench_dir: str = BENCH_DIR):
    """The module ``runners/<name>.py``."""
    return _module(os.path.join(bench_dir, "runners", f"{name}.py"),
                   f"perfbench_runner_{name}")
