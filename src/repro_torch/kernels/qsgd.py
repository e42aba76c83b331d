"""The QSGD kernels of GenQSGD's hot path, hand-written in CUDA for Hopper
(``csrc/qsgd.cu``), with their launch wrappers and plain PyTorch versions.

  K1 :func:`qsgd_sumsq`          replaces ``repro/kernels/qsgd.py``
                                 ``_sumsq_kernel`` / ``sumsq_kernel_call``
  K2 :func:`qsgd_quantize`       replaces ``_quantize_kernel`` /
                                 ``quantize_kernel_call``
  K3 :func:`qsgd_dequant_apply`  replaces ``_dequant_apply_kernel`` /
                                 ``dequant_apply_kernel_call``
  K3b :func:`qsgd_dequant_apply_bucketed`  K3 with one norm per bucket of
                                 q coordinates; replaces no TPU kernel (the
                                 JAX package's Pallas backend refuses
                                 buckets): it is ``decode_bucketed`` then
                                 the update, ``compress/backends.py``

What bounds them on the card: each is one streaming pass (K1 reads 4n
bytes, K2 reads 8n and writes n or 4n, K3 reads 4n plus the levels and
writes 4n) with a handful of flops per element, so device-memory bandwidth
(3.35 TB/s on an H100 SXM) bounds them at large n; at the model's
D = 101,770 a launch moves well under a megabyte and launch latency
bounds them.  The design therefore batches: K1 and K2 take a (rows, n)
matrix, so the N worker uploads of a round are one launch each, and K1
leaves norm and ``inv = s / norm`` on the device, so an encode never
synchronizes with the host.  K1 is one launch and deterministic: each
block writes its partial sum, and the last block of a row (by an integer
ticket, :func:`_tickets`) adds them in a fixed order; no float atomics.
Levels are int8 for s <= 127, as on the TPU, and int32 above (the paper's
s = 2^14).

Per-bucket norms (QSGD bucketing) need no kernel of their own on the
encode side: K1 and K2 run on the (rows * n_buckets, q) matrix of bucket
rows.  Where that exceeds the grid's 65,535 rows (q = 8 over ten model
deltas is 127,220 rows) the wrappers launch once per chunk of rows on the
current stream, so K1's tickets serve each chunk in turn.  The server's
apply takes one norm per bucket: K3b, the same one 16-byte item a thread
as K3, with each item's bucket walked without a division in the loop; an
item that straddles a bucket edge takes its norm per element.

Each wrapper runs the kernel for a CUDA tensor and the plain version for a
CPU tensor — only because the tensor lies on the CPU; a CUDA tensor never
falls back.  ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["LAUNCHES", "reset_launches", "level_dtype", "sumsq_blocks",
           "row_chunks", "qsgd_sumsq", "qsgd_quantize", "qsgd_dequant_apply",
           "qsgd_dequant_apply_bucketed", "sumsq_plain", "quantize_plain",
           "dequant_apply_plain", "dequant_apply_bucketed_plain"]

#: kernel launches per wrapper (the plain versions never count); a call
#: over more rows than one grid holds counts one launch per chunk
LAUNCHES = {"qsgd_sumsq": 0, "qsgd_quantize": 0, "qsgd_dequant_apply": 0,
            "qsgd_dequant_apply_bucketed": 0}

_THREADS = 256
_MAX_ROWS = 65535          # grid.y limit
_PTR, _LL, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
#: argument types of the C entry points in csrc/qsgd.cu, stream excluded
_SIGS = {
    "qsgd_sumsq": [_PTR, _LL, _LL, ctypes.c_int, _F32] + [_PTR] * 5,
    "qsgd_quantize_i8": [_PTR] * 3 + [_LL] * 2 + [_PTR],
    "qsgd_quantize_i32": [_PTR] * 3 + [_LL] * 2 + [_PTR],
    "qsgd_dequant_apply_i8": [_PTR] * 3 + [_F32] * 2 + [_LL, _PTR],
    "qsgd_dequant_apply_i32": [_PTR] * 3 + [_F32] * 2 + [_LL, _PTR],
    "qsgd_dequant_apply_bucketed_i8": [_PTR] * 3 + [_F32] * 2
    + [_LL, _LL, _PTR],
    "qsgd_dequant_apply_bucketed_i32": [_PTR] * 3 + [_F32] * 2
    + [_LL, _LL, _PTR],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def level_dtype(s: int) -> torch.dtype:
    """Narrowest signed container for levels in [-s, s]."""
    return torch.int8 if s <= 127 else torch.int32


def sumsq_blocks(n: int) -> int:
    """K1's (and K4's) blocks per row: about 16 floats a thread, at most
    1024 (a function of n alone, so the reduction order never changes)."""
    return max(1, min(1024, -(-n // (_THREADS * 16))))


_TICKETS: dict = {}


def row_chunks(rows: int):
    """``(first row, rows)`` of each launch over ``rows`` rows: chunks of at
    most the grid's 65,535 rows, in order."""
    return [(r, min(_MAX_ROWS, rows - r)) for r in range(0, rows, _MAX_ROWS)]


def _tickets(device: torch.device) -> torch.Tensor:
    """K1's per-row tickets on ``device``: ``_MAX_ROWS`` int32 zeros,
    allocated once and kept; each launch's last block of a row sets its
    ticket back to 0 (so a CUDA-graph replay finds them zero too).  K1 runs
    on PyTorch's current stream: two K1 launches in flight at once on
    different streams of one device would share the tickets, which the
    port never does."""
    t = _TICKETS.get(device)
    if t is None:
        t = torch.zeros(_MAX_ROWS, dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _on_card(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"the kernels take tensors on one CUDA device (or "
                         f"all on the CPU), got {[str(t.device) for t in tensors]}")
    return True


def _check(t: torch.Tensor, name: str, dtype, ndim: int):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-d {dtype} tensor, "
                         f"got {tuple(t.shape)} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it starts on a 16-byte boundary, else an aligned
    contiguous copy: for kernels whose 16-byte loads or tensor maps need
    one (a contiguous view such as ``torch.rand(d + 1)[1:]`` starts 4 bytes
    off).  The kernel still runs, on the copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


def _launch(name: str, *args):
    build.launch("qsgd", name, _SIGS[name], *args)


# ---------------------------------------------------------------------------
# plain versions: the same functions, written straightforwardly
# ---------------------------------------------------------------------------
def sumsq_plain(y: torch.Tensor, s):
    """(ss, norm, inv) per row of a (rows, n) f32 matrix."""
    ss = torch.sum(y * y, dim=-1)
    norm = torch.sqrt(ss)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    # tensor / tensor: a Python scalar on the left would run as
    # reciprocal-times-scalar, not as the kernel's IEEE division
    return ss, norm, torch.full_like(safe, float(s)) / safe


def quantize_plain(y: torch.Tensor, u: torch.Tensor, inv: torch.Tensor, s):
    """sign(y) * (floor(|y| inv) + [u < frac]) per row, in level_dtype(s)."""
    scaled = torch.abs(y) * inv[:, None]
    base = torch.floor(scaled)
    lvl = base + (u < (scaled - base)).to(torch.float32)
    return (torch.sign(y) * lvl).to(level_dtype(s))


def dequant_apply_plain(x: torch.Tensor, lvl: torch.Tensor, norm: torch.Tensor,
                        s, gamma: float):
    """x + (gamma * lvl) * (norm / s)."""
    n1 = norm.reshape(1)
    scale = n1 / torch.full_like(n1, float(s))   # IEEE division, as K3
    return x + (float(gamma) * lvl.to(torch.float32)) * scale


def dequant_apply_bucketed_plain(x: torch.Tensor, lvl: torch.Tensor,
                                 norms: torch.Tensor, s, gamma: float,
                                 q: int):
    """x + (gamma * lvl) * (norms[i // q] / s): K3 with one norm per
    bucket of ``q`` coordinates."""
    scale = norms / torch.full_like(norms, float(s))
    idx = torch.arange(x.shape[0], device=x.device) // int(q)
    return x + (float(gamma) * lvl.to(torch.float32)) * scale[idx]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def qsgd_sumsq(y: torch.Tensor, s):
    """K1: y (rows, n) f32 -> (ss, norm, inv), each (rows,) f32, with
    ``inv = s / (norm if norm > 0 else 1)``."""
    _check(y, "qsgd_sumsq y", torch.float32, 2)
    if not _on_card(y):
        return sumsq_plain(y, s)
    rows, n = y.shape
    if rows < 1 or n < 1:
        raise ValueError(f"qsgd_sumsq: bad shape {tuple(y.shape)}")
    P = sumsq_blocks(n)
    partials = torch.empty(min(rows, _MAX_ROWS) * P, dtype=torch.float32,
                           device=y.device)
    ss, norm, inv = (torch.empty(rows, dtype=torch.float32, device=y.device)
                     for _ in range(3))
    for r0, r in row_chunks(rows):     # partials reused: one stream
        _launch("qsgd_sumsq", y[r0].data_ptr(), r, n, P, float(s),
                partials.data_ptr(), _tickets(y.device).data_ptr(),
                ss[r0:].data_ptr(), norm[r0:].data_ptr(),
                inv[r0:].data_ptr())
        LAUNCHES["qsgd_sumsq"] += 1
    return ss, norm, inv


def qsgd_quantize(y: torch.Tensor, u: torch.Tensor, inv: torch.Tensor, s):
    """K2: y, u (rows, n) f32, inv (rows,) f32 -> levels (rows, n) in
    ``level_dtype(s)``."""
    _check(y, "qsgd_quantize y", torch.float32, 2)
    _check(u, "qsgd_quantize u", torch.float32, 2)
    _check(inv, "qsgd_quantize inv", torch.float32, 1)
    if u.shape != y.shape or inv.shape[0] != y.shape[0]:
        raise ValueError(f"qsgd_quantize: shapes y {tuple(y.shape)} u "
                         f"{tuple(u.shape)} inv {tuple(inv.shape)}")
    if not _on_card(y, u, inv):
        return quantize_plain(y, u, inv, s)
    rows, n = y.shape
    if rows < 1 or n < 1:
        raise ValueError(f"qsgd_quantize: bad shape {tuple(y.shape)}")
    dt = level_dtype(s)
    out = torch.empty((rows, n), dtype=dt, device=y.device)
    name = "qsgd_quantize_i8" if dt == torch.int8 else "qsgd_quantize_i32"
    for r0, r in row_chunks(rows):
        _launch(name, y[r0].data_ptr(), u[r0].data_ptr(),
                inv[r0:].data_ptr(), r, n, out[r0].data_ptr())
        LAUNCHES["qsgd_quantize"] += 1
    return out


def qsgd_dequant_apply(x: torch.Tensor, lvl: torch.Tensor, norm: torch.Tensor,
                       s, gamma: float):
    """K3: x (n,) f32, levels (n,) in ``level_dtype(s)``, norm (1,) or ()
    f32 -> ``x + (gamma * lvl) * (norm / s)`` (n,) f32, out of place."""
    _check(x, "qsgd_dequant_apply x", torch.float32, 1)
    _check(lvl, "qsgd_dequant_apply lvl", level_dtype(s), 1)
    if norm.dtype != torch.float32 or norm.numel() != 1 \
            or lvl.shape != x.shape:
        raise ValueError(f"qsgd_dequant_apply: x {tuple(x.shape)} lvl "
                         f"{tuple(lvl.shape)} norm {tuple(norm.shape)} "
                         f"{norm.dtype}")
    if not _on_card(x, lvl, norm):
        return dequant_apply_plain(x, lvl, norm, s, gamma)
    n = x.shape[0]
    if n < 1:
        raise ValueError("qsgd_dequant_apply: empty x")
    out = torch.empty_like(x)
    name = ("qsgd_dequant_apply_i8" if lvl.dtype == torch.int8
            else "qsgd_dequant_apply_i32")
    _launch(name, x.data_ptr(), lvl.data_ptr(), norm.data_ptr(), float(s),
            float(gamma), n, out.data_ptr())
    LAUNCHES["qsgd_dequant_apply"] += 1
    return out


def qsgd_dequant_apply_bucketed(x: torch.Tensor, lvl: torch.Tensor,
                                norms: torch.Tensor, s, gamma: float,
                                q: int):
    """K3b: x (n,) f32, levels (n,) in ``level_dtype(s)``, norms
    (ceil(n/q),) f32 -> ``x + (gamma * lvl) * (norms[i // q] / s)`` (n,)
    f32, out of place.  At q >= n it computes K3's bytes (one bucket)."""
    _check(x, "qsgd_dequant_apply_bucketed x", torch.float32, 1)
    _check(lvl, "qsgd_dequant_apply_bucketed lvl", level_dtype(s), 1)
    _check(norms, "qsgd_dequant_apply_bucketed norms", torch.float32, 1)
    n, q = x.shape[0], int(q)
    if q < 1 or lvl.shape != x.shape or norms.shape[0] != -(-n // q):
        raise ValueError(f"qsgd_dequant_apply_bucketed: x {tuple(x.shape)} "
                         f"lvl {tuple(lvl.shape)} norms "
                         f"{tuple(norms.shape)} q {q}")
    if not _on_card(x, lvl, norms):
        return dequant_apply_bucketed_plain(x, lvl, norms, s, gamma, q)
    if n < 1:
        raise ValueError("qsgd_dequant_apply_bucketed: empty x")
    out = torch.empty_like(x)
    name = ("qsgd_dequant_apply_bucketed_i8" if lvl.dtype == torch.int8
            else "qsgd_dequant_apply_bucketed_i32")
    _launch(name, x.data_ptr(), lvl.data_ptr(), norms.data_ptr(), float(s),
            float(gamma), n, q, out.data_ptr())
    LAUNCHES["qsgd_dequant_apply_bucketed"] += 1
    return out
