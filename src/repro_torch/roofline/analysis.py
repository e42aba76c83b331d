"""Roofline arithmetic (``repro/roofline/analysis.py``), against the H100.

Three terms per (arch × shape), in seconds:
    compute    = FLOPs / (chips × peak_FLOP/s)
    memory     = bytes / (chips × HBM_bw)
    collective = collective_bytes / (chips × link_bw)

FLOPs and bytes come from running a case's step on fake tensors
(:mod:`repro_torch.launch.roofline`), not from a compiled program.
``repro``'s ``cost_summary`` (reads XLA's ``compiled.cost_analysis()``)
and ``collective_bytes`` (parses the collectives of XLA's HLO text) have
no counterpart: there is no XLA artifact here, and one card moves no
collective bytes.  ``TPU_V5E`` is not carried; :data:`H100` is the card's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["HW", "H100", "roofline_terms", "extrapolate", "encode_bytes",
           "achieved_bandwidth", "host_peak_bandwidth"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float     # bf16 FLOP/s per chip
    hbm_bw: float         # bytes/s per chip
    ici_bw: float         # bytes/s per link per chip


#: NVIDIA's H100 SXM5 data sheet: dense bf16 tensor FLOP/s, HBM3 bytes/s,
#: NVLink 4 bytes/s per direction
H100 = HW("h100_sxm", 989e12, 3.35e12, 450e9)


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, hw: HW = H100) -> Dict:
    compute = flops / (chips * hw.peak_flops)
    memory = bytes_accessed / (chips * hw.hbm_bw)
    collective = coll_bytes / (chips * hw.ici_bw)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    total = max(compute, memory, collective)
    terms["bound_s"] = total
    return terms


_PAYLOAD_BYTES = {"int4": 0.5, "int8": 1.0}


def encode_bytes(n: int, wire: str = "int4",
                 pipeline: str = "fused") -> Dict:
    """Bytes moved through device memory by one QSGD tensor encode of
    ``n`` f32 coordinates, attributed per pass.

    ``pipeline="multipass"`` is the staged pipeline (K1 then K2, then the
    pack): a sumsq pass (read y), a quantize pass (read y + noise,
    materialize the levels as f32), and a pack pass (re-read the levels,
    write the wire container).  ``pipeline="fused"`` is the payload
    encode K4 (``repro_torch.kernels.fused_encode``) on its two-launch
    route: a norm phase (read y) and a quantize+pack phase (read y +
    noise, write the container) — the f32 level round-trip disappears.
    K4's one cooperative launch keeps y in registers between its phases,
    so it reads y once: 4n bytes below this model.

    In the memory-bound regime time ~ bytes / HBM_bw, so the model
    throughput ratio multipass/fused (~1.6x for both int wires) is the
    fused pipeline's expected speedup.
    """
    if wire not in _PAYLOAD_BYTES:
        raise ValueError(f"encode_bytes models the packed level wires "
                         f"{sorted(_PAYLOAD_BYTES)}, got {wire!r}")
    out_b = _PAYLOAD_BYTES[wire] * n
    if pipeline == "multipass":
        passes = {"sumsq": {"read": 4.0 * n, "write": 0.0},
                  "quantize": {"read": 8.0 * n, "write": 4.0 * n},
                  "pack": {"read": 4.0 * n, "write": out_b}}
    elif pipeline == "fused":
        passes = {"norm_phase": {"read": 4.0 * n, "write": 0.0},
                  "quantize_pack_phase": {"read": 8.0 * n, "write": out_b}}
    else:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    total = sum(p["read"] + p["write"] for p in passes.values())
    return {"passes": passes, "total_bytes": total}


def achieved_bandwidth(nbytes: float, seconds: float) -> float:
    """bytes/s actually sustained moving ``nbytes`` in ``seconds``."""
    return nbytes / max(seconds, 1e-12)


def host_peak_bandwidth(mib: int = 256, reps: int = 5) -> float:
    """Measured peak memory bandwidth of *this* host (bytes/s): the best
    of ``reps`` large numpy copies — the denominator for achieved-vs-peak
    on CPU runs, where ``HW.hbm_bw`` describes a card we are not on."""
    import time

    import numpy as np
    src = np.ones(mib * (1 << 20) // 8, np.float64)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2.0 * src.nbytes / best  # read + write


def extrapolate(cost1: Dict, cost2: Dict, reps: float) -> Dict:
    """total = cost1 + (reps - 1) * (cost2 - cost1), clamped at >= cost1."""
    out = {}
    for k in set(cost1) | set(cost2):
        c1 = float(cost1.get(k, 0.0))
        c2 = float(cost2.get(k, 0.0))
        per = max(c2 - c1, 0.0)
        out[k] = c1 + (reps - 1.0) * per
    return out
