#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
in PERF.md).

    python3 chip_smoke.py

Phases, each of which fails the script on error:
  1. build: nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a into
     ``build/`` (one nvcc per source, all started together);
  2. kernels vs plain: every QSGD kernel against its plain PyTorch version
     on the card, at the main path's shapes (10 and 1 rows of
     D = 101,770) and at a streaming size (n = 2^24), for s in
     {7, 127, 16384}: K2 bitwise given the same inv, K1's norm within
     rtol 1e-6, K3 within rtol 1e-5 / atol 1e-6; then each kernel's time
     beside its plain version's, its byte bound and a one-call PyTorch
     yardstick where one exists (device times from CUDA-graph replay,
     beside the eager call's time with its host work);
  3. main path: the README quickstart loop on the card —
     ``MNISTTask.estimate_constants`` -> ``Scenario.optimize()`` ->
     ``Scenario.run(plan, max_rounds=400)`` at full width (D = 101,770,
     N = 10, s0 = sn = 2^14) — with the kernels' launch counters set to 0
     just before the run and read just after; one round on the card is
     also held against the same round on the CPU (plain versions) with the
     same draws, and 20 rounds are profiled (device time by kernel, the
     device's busy share).

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
MAIN_D = 784 * 128 + 128 + 128 * 10 + 10
STREAM_N = 1 << 24
S_VALUES = (7, 127, 16384)
REPLACES = {
    "qsgd_sumsq": "src/repro/kernels/qsgd.py:143",
    "qsgd_quantize": "src/repro/kernels/qsgd.py:82",
    "qsgd_dequant_apply": "src/repro/kernels/qsgd.py:109",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_ms(fn, reps: int = 50, trials: int = 5) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    eager calls, by CUDA events: host work (Python, allocation, launch)
    included wherever it is slower than the device."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def device_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so no host work sits between the kernels; median over
    ``trials`` replays, by CUDA events, after a warm-up."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(out)


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import build
    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        results = list(ex.map(build.build, sources))
    for name, (path, secs, out) in zip(sources, results):
        log(f"[build] {name}: {os.path.relpath(path, ROOT)} "
            f"(nvcc {secs:.2f} s)")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels import qsgd as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(10, MAIN_D), (1, MAIN_D), (1, STREAM_N)]
    worst = {k: 0.0 for k in K.LAUNCHES}
    for rows, n in shapes:
        y = torch.randn(rows, n, generator=gen, device=dev) * 3.0
        u = torch.rand(rows, n, generator=gen, device=dev)
        x = torch.randn(n, generator=gen, device=dev)
        for s in S_VALUES:
            ss, norm, inv = K.qsgd_sumsq(y, s)
            ss_p, norm_p, inv_p = K.sumsq_plain(y, s)
            lvl = K.qsgd_quantize(y, u, inv, s)
            lvl_p = K.quantize_plain(y, u, inv, s)
            out = K.qsgd_dequant_apply(x, lvl[0], norm[:1], s, 0.05)
            out_p = K.dequant_apply_plain(x, lvl[0], norm[:1], s, 0.05)
            torch.cuda.synchronize()
            torch.testing.assert_close(norm, norm_p, rtol=1e-6, atol=0)
            if not torch.equal(lvl, lvl_p):
                bad = int((lvl != lvl_p).sum())
                raise AssertionError(f"K2 levels differ from the plain "
                                     f"version at {bad} of {lvl.numel()} "
                                     f"(rows={rows} n={n} s={s})")
            if int(lvl.abs().max()) > s:
                raise AssertionError(f"K2 level above s={s}")
            torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-6)
            if (rows, n) == shapes[0] or (rows, n) == (1, MAIN_D):
                worst["qsgd_sumsq"] = max(worst["qsgd_sumsq"], float(
                    (norm - norm_p).abs().max()))
                worst["qsgd_dequant_apply"] = max(
                    worst["qsgd_dequant_apply"],
                    float((out - out_p).abs().max()))
            log(f"[kernels] rows={rows} n={n} s={s}: K1 norm rel err "
                f"{float(((norm - norm_p).abs() / norm_p).max()):.3g}, "
                f"K2 bitwise, K3 max abs err "
                f"{float((out - out_p).abs().max()):.3g}")
    log("[kernels] all kernels agree with their plain versions")

    # times at the main path's shapes (s = 2^14: int32 levels) and at the
    # streaming size
    s = 16384
    rows_main = []
    for rows, n in shapes:
        y = torch.randn(rows, n, generator=gen, device=dev)
        u = torch.rand(rows, n, generator=gen, device=dev)
        x = torch.randn(n, generator=gen, device=dev)
        _, norm, inv = K.qsgd_sumsq(y, s)
        lvl = K.qsgd_quantize(y, u, inv, s)
        lvl0, norm0 = lvl[0].contiguous(), norm[:1]
        scale0 = float(norm0) / s
        e = rows * n
        calls = {
            "qsgd_sumsq": (lambda: K.qsgd_sumsq(y, s),
                           lambda: K.sumsq_plain(y, s),
                           lambda: torch.linalg.vector_norm(y, dim=-1),
                           bound_ms(4 * e + 12 * rows, 2 * e)),
            "qsgd_quantize": (lambda: K.qsgd_quantize(y, u, inv, s),
                              lambda: K.quantize_plain(y, u, inv, s),
                              None,
                              bound_ms(12 * e + 4 * rows, 6 * e)),
            "qsgd_dequant_apply": (
                lambda: K.qsgd_dequant_apply(x, lvl0, norm0, s, 0.05),
                lambda: K.dequant_apply_plain(x, lvl0, norm0, s, 0.05),
                lambda: torch.add(x, lvl0, alpha=0.05 * scale0),
                bound_ms(12 * n + 4, 3 * n)),
        }
        t = {}
        for name, (kern, plain, lib, (bnd, by)) in calls.items():
            if name == "qsgd_dequant_apply" and rows != 1:
                continue
            t[name] = (device_ms(kern), device_ms(plain),
                       None if lib is None else device_ms(lib), (bnd, by))
            ms, pl, lb, _ = t[name]
            log(f"[time] {name} rows={rows} n={n}: kernel {ms * 1e3:.2f} us "
                f"(eager call {eager_ms(kern) * 1e3:.2f} us), plain "
                f"{pl * 1e3:.2f} us, library "
                f"{'n/a' if lb is None else f'{lb * 1e3:.2f} us'}, "
                f"bound {bnd * 1e3:.2f} us ({by})")
        if (rows, n) in ((10, MAIN_D), (1, MAIN_D)):
            rows_main.append(((rows, n), t))
    # the JSON line reports each kernel at its main-path shape: K1/K2 at the
    # batched worker encode (10 x D), K3 at the server apply (D,)
    main = {}
    for (rows, n), t in rows_main:
        for name, v in t.items():
            if (name == "qsgd_dequant_apply") == (rows == 1):
                main[name] = v
    return {"worst": worst, "main": main}


def phase_main_path() -> dict:
    import numpy as np
    import torch
    from repro_torch.api import EdgeSystem, MNISTTask, Scenario
    from repro_torch.core.genqsgd import GenQSGD, flatten_like
    from repro_torch.kernels import qsgd as K

    t0 = time.perf_counter()
    task = MNISTTask(device="cuda")
    consts = task.estimate_constants(N=10, n_iters=120)
    torch.cuda.synchronize()
    log(f"[main] constants L={consts.L:.4g} sigma={consts.sigma:.4g} "
        f"G={consts.G:.4g} f_gap={consts.f_gap:.4g} "
        f"({time.perf_counter() - t0:.2f} s with data)")
    system = EdgeSystem.paper_sec_vii(dim=task.dim)
    scenario = Scenario(system=system, consts=consts, T_max=1e5, C_max=0.25)
    t0 = time.perf_counter()
    plan = scenario.optimize()
    log(f"[main] optimize {time.perf_counter() - t0:.2f} s: "
        f"{plan.describe()}")
    if not plan.feasible:
        raise AssertionError("the optimizer returned an infeasible Plan")

    rounds = min(plan.K0, 400)
    scenario.run(plan, task=task, max_rounds=2)        # warm-up, not counted
    K.reset_launches()
    report = scenario.run(plan, task=task, max_rounds=rounds)
    launches = dict(K.LAUNCHES)
    log(report.summary())
    ms_round = report.wall_time_s / report.rounds * 1e3
    log(f"[main] {report.rounds} rounds, {ms_round:.3f} ms/round, "
        f"test_acc {report.final_metrics['test_acc']:.4f}, "
        f"launches {launches}")

    # right answers: exact comm bits, a finite model that learned, kernels
    # launched as the design says, and a card round equal to the CPU one
    want_bits = report.rounds * (float(np.sum(system.M_sn)) + system.M_s0)
    if report.comm_bits != want_bits:
        raise AssertionError(f"comm bits {report.comm_bits} != "
                             f"rounds * (sum M_sn + M_s0) = {want_bits}")
    if report.comm_bits_match != (report.rounds == plan.K0):
        raise AssertionError("comm_bits_match disagrees with the round count")
    m = report.final_metrics
    if not (np.isfinite(m["eval_loss"]) and m["test_acc"] > 0.2):
        raise AssertionError(f"the run did not learn: {m}")
    workers = 1 if len(set(plan.sn)) == 1 else plan.N
    server = 0 if plan.s0 is None else 1
    want = {"qsgd_sumsq": rounds * (workers + server),
            "qsgd_quantize": rounds * (workers + server),
            "qsgd_dequant_apply": rounds * server}
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")

    cfg = plan.to_genqsgd_config(max_K0=1)
    cpu_task = MNISTTask(device="cpu")
    algs = {d: GenQSGD(t.loss, t.make_data(plan.N), t.shapes, cfg)
            for d, t in (("cuda", task), ("cpu", cpu_task))}
    gen = torch.Generator(device="cpu").manual_seed(7)
    x0 = flatten_like(cpu_task.init_params(gen))
    D = x0.shape[0]
    idx = torch.randint(0, algs["cpu"].n_local, (plan.N, plan.K_max, plan.B),
                        generator=gen)
    uw, us = torch.rand(plan.N, D, generator=gen), torch.rand(D, generator=gen)
    gamma = plan.gamma
    x_cpu, m_cpu = algs["cpu"].round(x0, idx, uw, us, gamma)
    x_gpu, _ = algs["cuda"].round(x0.cuda(), idx.cuda(), uw.cuda(), us.cuda(),
                                  gamma)
    diff = (x_gpu.cpu() - x_cpu).abs()
    # float32 gradients differ between the card and the CPU; where they move
    # a value across a level boundary the result moves by one level of the
    # server's (gamma * norm / s0) or 1/N of a worker's
    level = gamma * float(m_cpu["delta_norm"]) / plan.s0
    if float(diff.max()) > 2 * level + 1e-6 or \
            int((diff > 1e-6).sum()) > D // 1000:
        raise AssertionError(f"card round differs from the CPU round: max "
                             f"{float(diff.max()):.3g} (level {level:.3g}), "
                             f"{int((diff > 1e-6).sum())} coordinates")
    log(f"[main] one round card vs CPU: max abs diff {float(diff.max()):.3g} "
        f"(server level {level:.3g})")
    profile_rounds(algs["cuda"], x_gpu, (idx.cuda(), uw.cuda(), us.cuda()),
                   gamma)
    return {"launches": launches, "ms_round": ms_round}


def profile_rounds(alg, x, draws, gamma, rounds: int = 20) -> None:
    """Where a round's time goes: torch.profiler over ``rounds`` rounds,
    device time by kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        x, _ = alg.round(x, *draws, gamma)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            x, _ = alg.round(x, *draws, gamma)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an operator's own row also carries the time
    # of the kernels it launched, so summing both would count them twice
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] {rounds} rounds: wall {wall / rounds * 1e3:.3f} "
        f"ms/round (profiler on), device busy "
        f"{busy_us / rounds / 1e3:.3f} ms/round = "
        f"{busy_us / 1e6 / wall * 100:.1f}% of wall")
    if not events:
        log("[profile] the profiler recorded no device time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / rounds:9.1f} us/round "
            f"{e.count / rounds:6.1f} launches/round  {e.key[:90]}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_all = time.perf_counter()
    phase_build()
    kern = phase_kernels()
    path = phase_main_path()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kernels = []
    for name, (ms, plain, lib, (bnd, by)) in kern["main"].items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/qsgd.cu",
            "replaces": REPLACES[name],
            "launches": path["launches"][name],
            "max_abs_err": kern["worst"][name],
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib})
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
