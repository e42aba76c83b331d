"""Runner of the federated-training mixes: GenQSGD rounds through the
port's trainer (``repro_torch.train.trainer.GenQSGDTrainer.run``, which
drives ``repro_torch.fed.runtime.make_round_fn``'s round), all fl workers
on one card over ``LocalTransport``.

A run:
  1. set-up: builds one trainer and its state from the run's weights,
     then drives that same object through the first ``check_rounds``
     rounds, each through the window's own call and feed (rows that all
     differ), and keeps what the comparison reads: each round's loss and
     each leaf's ‖x̂_r - x̂_0‖ after the first and the last of them;
  2. the window: whole rounds, one ``run`` call each (its history record
     reads the round's loss, which waits for the card), until ``seconds``
     have passed; it ends with a synchronize;
  3. with ``trace``: one round to warm the profiler, then
     ``trace_rounds`` rounds under ``torch.profiler``, the benchmark's
     ranges open around each round, each call into ``local_train`` and
     ``aggregate_apply`` and each QSGD launch wrapper;
  4. the peak memory is read, the program's state freed, and the plain
     reference (``perfbench/reference/genqsgd.py``) follows the checked
     rounds from the same weights, batches and key words.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import torch

from perfbench import inputs
from perfbench.reference import genqsgd
from perfbench.reference.tree import leaves
from perfbench.roofline import QSGD_KERNELS
from perfbench.trace import Trace

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` from the configuration's ``arch`` block."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg["arch"].items()})


class Program:
    """The system under test: one trainer, its state and its feed."""

    def __init__(self, spec: dict, seed: int, device, dtype=F32):
        from repro_torch.core.step_rules import make_rule
        from repro_torch.fed import FedConfig, LocalTransport
        from repro_torch.models.registry import model_api
        from repro_torch.train.trainer import GenQSGDTrainer, TrainState
        cfg, traffic, job = spec["config"], spec["traffic"], spec["job"]
        arch = arch_config(cfg)
        fed = FedConfig(n_workers=job["fl"], Kn=tuple(job["Kn"]),
                        s0=traffic["s0"], sn=traffic["sn"],
                        wire=traffic["wire"],
                        microbatch=job.get("microbatch", 1))
        self.trainer = GenQSGDTrainer(
            model_api(arch), arch, fed, LocalTransport(job["fl"]),
            make_rule(traffic["rule"], traffic["gamma"]), None, device)
        self.state = TrainState(
            params=inputs.make_weights(cfg, seed, device, dtype), round=0,
            history=[])
        self.feed = (inputs.round_batch(cfg, job, seed, r, device)
                     for r in itertools.count())
        self.cfg, self.seed, self.device, self.dtype = cfg, seed, device, dtype

    def round(self):
        """One whole round through the trainer's ``run``."""
        self.trainer.run(self.state, self.feed,
                         inputs.key_seed(self.seed, self.state.round),
                         n_rounds=1, log_every=1)

    def change(self) -> list:
        """Each leaf's ‖x̂ - x̂_0‖, x̂_0 made again leaf by leaf."""
        from repro_torch.fed import tree_leaves
        out = []
        for i, (x, leaf) in enumerate(zip(tree_leaves(self.state.params),
                                          leaves(inputs.param_spec(self.cfg)))):
            x0 = inputs.make_leaf(leaf, self.seed, i, self.device, self.dtype)
            out.append(float(torch.linalg.vector_norm(
                (x.to(F32) - x0.to(F32)).to(torch.float64))))
            del x0
        return out

    def check_rounds(self, n: int) -> dict:
        """The first ``n`` rounds, with what the comparison reads."""
        out = {"loss": [], "change": []}
        for _ in range(n):
            self.round()
            out["loss"].append(self.state.history[-1]["loss"])
            out["change"].append(self.change())
        return out

    def profile(self, n_active: int) -> Trace:
        """``n_active`` rounds under the profiler, after one that warms it."""
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
        path = os.path.join(tmp, "trace.json")
        try:
            with _ranges(), profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    schedule=schedule(wait=0, warmup=1, active=n_active,
                                      repeat=1),
                    on_trace_ready=lambda p: p.export_chrome_trace(path)
            ) as prof:
                for _ in range(1 + n_active):
                    with record_function("bench.round"):
                        self.round()
                    prof.step()
            return Trace.load(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def _shape_label(name: str, args) -> str:
    """``bench.kernel.<wrapper>:<rows>:<n>:<level bytes>`` for a QSGD
    wrapper's call (rows, n of its input; the levels' bytes each), or
    ``bench.kernel.<wrapper>`` where the arguments are not the ones this
    expects (the reader then finds no shape to read)."""
    try:
        if name == "qsgd_sumsq":
            rows, n = args[0].shape
            return f"bench.kernel.{name}:{rows}:{n}:0"
        if name == "qsgd_quantize":
            rows, n = args[0].shape
            return (f"bench.kernel.{name}:{rows}:{n}:"
                    f"{1 if args[3] <= 127 else 4}")
        return (f"bench.kernel.{name}:1:{args[0].shape[0]}:"
                f"{args[1].element_size()}")
    except (AttributeError, IndexError, TypeError, ValueError):
        return f"bench.kernel.{name}"


@contextlib.contextmanager
def _ranges():
    """The benchmark's profiler ranges around the round's calls into its
    layers (``bench.layer.*``) and each QSGD launch (``bench.kernel.*``),
    opened by wrapping the functions the round looks up by module name."""
    from torch.profiler import record_function
    from repro_torch.fed import runtime
    from repro_torch.kernels import qsgd

    def ranged(fn, label):
        def wrapped(*args, **kwargs):
            with record_function(label(args)):
                return fn(*args, **kwargs)
        return wrapped
    saved = []
    for mod, name, label in (
            [(runtime, n, lambda a, n=n: f"bench.layer.{n}")
             for n in ("local_train", "aggregate_apply")]
            + [(qsgd, n, lambda a, n=n: _shape_label(n, a))
               for n in QSGD_KERNELS]):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, ranged(getattr(mod, name), label))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reference(spec: dict, seed: int, device, n_rounds: int) -> dict:
    """The plain reference's readings of the first ``n_rounds`` rounds of
    run ``seed``, TF32 off."""
    cfg, traffic, job = spec["config"], spec["traffic"], spec["job"]
    like = inputs.param_spec(cfg)
    x0 = [inputs.make_leaf(leaf, seed, i, device)
          for i, leaf in enumerate(leaves(like))]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return genqsgd.rounds(
            inputs.reference_model(cfg), cfg, like, x0,
            lambda r: inputs.round_batch(cfg, job, seed, r, device),
            lambda r: inputs.round_words(seed, r, job["fl"]),
            traffic["gamma"], job, traffic["s0"], traffic["sn"], n_rounds,
            DTYPES[cfg["precision"]["compute"]])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _gap(prog: list, ref: list, kept: list) -> float:
    """The worst leaf's |‖·‖_program - ‖·‖_reference| over the larger of
    that leaf's reference norm and the median kept leaf's."""
    med = statistics.median(ref[i] for i in kept)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in kept)


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared, each with its limit.

    ``loss_gap``: the largest relative gap of a checked round's loss.
    ``update_gap``: the first round's x̂_1 - x̂_0 by leaf (the update as
    the state shows it after one round).  ``change_gap``: x̂_n - x̂_0 by
    leaf after the last checked round.  Leaves whose first reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of both."""
    g = ref["grad"]
    med = statistics.median(g)
    kept = [i for i, v in enumerate(g) if v >= 1e-3 * med]
    values = {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "update_gap": _gap(prog["change"][0], ref["change"][0], kept),
        "change_gap": _gap(prog["change"][-1], ref["change"][-1], kept)}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


#: what ``nvidia-smi`` reads of the card right after the window
_SMI_FIELDS = ("clocks.sm", "clocks.max.sm", "power.draw", "power.limit",
               "temperature.gpu", "clocks_event_reasons.active")


def conditions(cpu_s: float, window_s: float) -> dict:
    """What the window ran under, kept beside the metrics to tell a slow
    card from a busy host: the share of the window's wall time in which
    this process ran on a CPU core, the host's load average over the last
    minute and its cores, and the card's SM clock, its maximum, power,
    power limit, temperature and active clock-limit reasons as
    ``nvidia-smi`` reads them just after the window (None where it cannot
    be read)."""
    out = {"host_cpu_share": cpu_s / window_s if window_s > 0 else None,
           "loadavg_1m": os.getloadavg()[0], "host_cores": os.cpu_count()}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--id=0", f"--query-gpu={','.join(_SMI_FIELDS)}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.strip()
        values = [v.strip() for v in line.splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, IndexError):
        values = [None] * len(_SMI_FIELDS)
    for key, v in zip(_SMI_FIELDS, values):
        try:
            out[key] = float(v) if key != _SMI_FIELDS[-1] else v
        except (TypeError, ValueError):
            out[key] = v
    return out


def release(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of the cell ``spec`` -> {"correct", "attempted", "failed",
    "values" (the end-to-end readings), "memory_peak_bytes" (the process's
    peak before the reference runs), "conditions" (:func:`conditions`),
    "checks", "trace" (the per-layer readers' context, with ``trace``)}."""
    job = spec["job"]
    on_card = torch.device(device).type == "cuda"
    prog = Program(spec, seed, device,
                   DTYPES[spec["config"]["precision"]["master"]])
    checked = prog.check_rounds(job["check_rounds"])
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0, c0 = time.time(), time.process_time()
    setup_s = t0 - t_start
    n = 0
    while True:
        prog.round()
        n += 1
        if time.time() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.time() - t0
    cond = conditions(time.process_time() - c0, window_s) if on_card \
        else {}
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    losses = [h["loss"] for h in prog.state.history[-n:]]
    ctx = None
    if trace:
        model = inputs.reference_model(spec["config"])
        ctx = {"trace": prog.profile(job["trace_rounds"]),
               "round_ms": window_s / n * 1e3,
               "flops_per_round": model.train_flops(spec["config"], job)
               * sum(job["Kn"])}
    if on_card:
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    del prog
    release(device)
    ref = reference(spec, seed, device, job["check_rounds"])
    checks = compare(checked, ref, job["limits"])
    failed = sum(1 for v in losses if not math.isfinite(v))
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    return {"correct": bool(correct), "attempted": n, "failed": failed,
            "values": {"round_ms": window_s / n * 1e3,
                       "peak_mem_gib": window_peak / 2 ** 30,
                       "setup_s": setup_s},
            "memory_peak_bytes": peak, "conditions": cond,
            "checks": checks, "trace": ctx}
