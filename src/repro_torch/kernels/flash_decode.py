"""Flash decode (K6): single-token GQA attention against a KV cache,
hand-written in CUDA for Hopper (``csrc/flash_decode.cu``), with its launch
wrapper and plain PyTorch version.

  K6 :func:`flash_decode`  replaces ``repro/kernels/flash_decode.py``
                           ``_flash_decode_kernel`` / ``flash_decode_call``

q (B, KV, G, dh) attends over k/v (B, C, KV, dh) where ``valid`` (B, C) is
nonzero: scores (q . k) / sqrt(dh) in f32, masked ones set to -1e30, a
softmax over C in f32, the weighted sum of v in f32, the result in q's
type.  A row with no valid entry gets uniform weights (the mean of v).
Head h = kv * G + g of the model is (kv, g) here, the JAX package's
grouping.

What bounds it: every cache entry is read once with about 4G flops per
element, so device-memory bandwidth (3.35 TB/s on an H100 SXM) does at
G <= 8: at qwen3-1.7b's serving shape (8 slots x 4096 positions x 8 kv
heads x 128, bf16) a call moves 134 MB.  The kernel is one launch: the
cache of each (b, kv) is split over :data:`SPLITS` blocks
(:func:`split_ranges`), each block streams its range through a ring in
shared memory filled by Hopper's tensor copies (TMA), and the last block of
each (b, kv) to finish, found by an integer ticket, merges the blocks' f32
(m, l, acc) in a fixed order, so B * KV = 64 (b, kv) pairs still fill the
132 SMs and the result is the same from run to run.  The merge's workspace
and tickets are kept per device (:func:`_scratch`): a call allocates only
its output.  It takes any C (the TPU kernel asked for a multiple of 512).

q is f32 or bf16, k and v f32 or bf16 (one type for both), G <= 16 and
dh in {64, 80, 128, 256}: the head widths of the configs the port serves
(80 is zamba2-2.7b's; its rows of 10 or 20 16-byte vectors are read by 16
or 32 lanes, the rest idle).  The
wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors — only because the tensors lie on the CPU; a CUDA tensor never
falls back, and a launch the card refuses raises.  ``LAUNCHES`` counts
wrapper calls that launched the kernel (one launch a call).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .qsgd import _aligned, _on_card

__all__ = ["LAUNCHES", "reset_launches", "SPLITS", "MAX_G", "HEAD_DIMS",
           "stage_positions", "split_ranges", "flash_decode",
           "flash_decode_plain"]

#: kernel launches per wrapper (the plain version never counts)
LAUNCHES = {"flash_decode": 0}

#: blocks a (b, kv): the cache of one (b, kv) is split this many ways
SPLITS = 8
#: bytes of K plus V a stage of the kernel's ring holds
_STAGE_BYTES = 8192
MAX_G = 16
HEAD_DIMS = (64, 80, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argument types of the C entry point in csrc/flash_decode.cu, stream
#: excluded
_SIG = ([_PTR] * 4 + [_INT] * 4 + [_LL, _INT, _INT]
        + [_PTR, _LL, _PTR, _LL, _PTR])
#: per device: (workspace f32, tickets int32), kept and grown, never shrunk
_SCRATCH: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stage_positions(dh: int, itemsize: int) -> int:
    """Cache positions a stage tile of the kernel holds: the rows of K and V
    that 8 KB hold, cut to a whole number of its consumer warps' loads (16
    at dh 128 over a bf16 cache; 24 at dh 80, where 25 rows fit).  The
    kernel's own tile is its library's (``flash_decode_tile``, which splits
    the cache by it); this is the CPU model's, which ``chip_smoke.py`` holds
    equal to the library's on the card."""
    row = dh * itemsize
    vectors = row // 16
    lanes = 1 << (vectors - 1).bit_length()    # a row's lanes, one vector each
    step = 4 * max(1, 32 // lanes)             # 4 warps x rows a warp load
    rows = _STAGE_BYTES // (2 * row)
    return rows - rows % step


def split_ranges(C: int, tile: int) -> tuple:
    """The kernel's split of C positions over a cluster: block r takes
    ``[lo, hi)`` with ``per = ceil(C / SPLITS)`` rounded up to ``tile``,
    ``lo = min(C, r * per)``, ``hi = min(C, lo + per)``; a range may be
    empty.  -> ``(per, [(lo, hi), ...])``."""
    per = -(-C // SPLITS)
    per = -(-per // tile) * tile
    ranges = []
    for r in range(SPLITS):
        lo = min(C, r * per)
        ranges.append((lo, min(C, lo + per)))
    return per, ranges


def _scratch(device, n_ws: int, n_tickets: int):
    """The merge's workspace and tickets on ``device``, allocated on first
    use and kept (regrown when a call needs more), so a call allocates only
    its output.  The last block of each (b, kv) puts its ticket back to 0.
    The kernel runs on PyTorch's current stream: two K6 launches in flight
    at once on different streams of one device would share them, which the
    port never does."""
    ws, tickets = _SCRATCH.get(device, (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _SCRATCH[device] = (ws, tickets)
    return ws, tickets


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The dense softmax in f32: the oracle of the JAX package's own test
    (``tests/kernels/test_flash_decode.py``), cast to q's type as the
    kernel's output is."""
    dh = q.shape[-1]
    s = torch.einsum("bhgd,bchd->bhgc", q.float(), k.float()) / math.sqrt(dh)
    s = s.masked_fill(~(valid[:, None, None, :] > 0), -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgc,bchd->bhgd", w, v.float()).to(q.dtype)


def _check(q, k, v, valid):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or valid.shape != (k.shape[0], k.shape[1]) \
            or q.shape[0] != k.shape[0] or q.shape[1] != k.shape[2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_decode: want q (B, KV, G, dh), k/v "
                         f"(B, C, KV, dh), valid (B, C); got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} valid {tuple(valid.shape)}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"flash_decode: q f32/bf16 and k, v of one type "
                         f"f32/bf16; got {q.dtype} {k.dtype} {v.dtype}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """K6: q (B, KV, G, dh), k/v (B, C, KV, dh), valid (B, C) (nonzero =
    attend) -> (B, KV, G, dh) in q's type."""
    _check(q, k, v, valid)
    if not _on_card(q, k, v, valid):
        return flash_decode_plain(q, k, v, valid)
    B, KV, G, dh = q.shape
    C = k.shape[1]
    if dh not in HEAD_DIMS or not 1 <= G <= MAX_G or C < 1 \
            or not 1 <= B <= _MAX_GRID_YZ or not 1 <= KV <= _MAX_GRID_YZ:
        raise ValueError(f"flash_decode: the kernel takes dh in {HEAD_DIMS}, "
                         f"G <= {MAX_G}, B and KV <= {_MAX_GRID_YZ}; got "
                         f"{tuple(q.shape)} against C={C}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    # the tensor maps and q's loads want 16-byte boundaries: a view off one
    # runs on an aligned copy (the serving path's caches are always aligned)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if valid.dtype != torch.bool:
        valid = valid > 0
    valid = valid.contiguous()
    gb = 1 << (G - 1).bit_length()                # the kernel's head bound
    n_ws = B * KV * SPLITS * (2 * gb + gb * dh)
    ws, tickets = _scratch(q.device, n_ws, B * KV)
    out = torch.empty_like(q)
    build.launch("flash_decode", "flash_decode", _SIG, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), valid.data_ptr(), B, KV, G, dh,
                 C, int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), ws.data_ptr(), ws.numel(),
                 tickets.data_ptr(), tickets.numel(), out.data_ptr())
    LAUNCHES["flash_decode"] += 1
    return out
