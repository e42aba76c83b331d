"""The one-pass QSGD encodes of the "int4" payload, hand-written in CUDA for
Hopper (``csrc/fused_encode.cu``), with their launch wrappers and plain
PyTorch versions.

  K4 :func:`fused_encode`         replaces ``repro/kernels/qsgd.py``
                                  ``_fused_encode_kernel`` /
                                  ``fused_encode_call``
  K5 :func:`fused_rotate_encode`  replaces ``fused_rotate_encode_call``
                                  (its inner ``kernel``)

K4 is norm + quantize (+ int4 pack) of a (rows, n) matrix, one message per
row.  Where every block of K1's grid (``sumsq_blocks(n)``, rows) fits on
the card at once and n <= 2^19 (:func:`k4_route`), it is one cooperative
launch: each thread keeps its few vectors of y and u in registers, the
blocks of a row meet at a barrier inside the launch to add the row's
partial sums in K1's order, and each thread quantizes and packs what it
holds; it moves 8.5n bytes packed (y and u once, n/2 out) and 9n
unpacked.  Elsewhere it is two launches, K1's partial sums and then a
quantize+pack that finishes the norm itself, and moves 12.5n / 13n (y
twice).  Both routes give the same bytes and K1's norm bit for bit, and
levels never reach device memory.  Device-memory bandwidth bounds K4 at
large n and launch latency at the model's D = 101,770.  K5 is
the rotated twin for a power-of-two d <= 2^15: one message is spread over
a thread block cluster of :func:`k5_cluster` blocks (8 at 2^15), each
holding a chunk of at most 4,096 coordinates in shared memory through the
Rademacher signs and the butterflies of its chunk; the cross-chunk
butterflies, the norm and the quantize run after an exchange through
distributed shared memory.  It is bound by the latency of its chain of
stages, not by bytes.  Levels are int8 (s <= 127; packing carries s <= 7).

Plain versions: :func:`fused_encode_plain` is ``sumsq_plain`` +
``quantize_plain`` + ``pack_int4``, :func:`fused_rotate_encode_plain` is
``rotate`` + the same.  Each wrapper runs its kernel for CUDA tensors and
the plain version for CPU tensors — only because the tensors lie on the
CPU; a CUDA tensor never falls back.  ``LAUNCHES`` counts K4's and K5's
launches (K4 over more than the grid's 65,535 rows, as QSGD bucketing's
bucket rows can be, launches once per chunk of rows, each on its own
:func:`k4_route`), ``ROUTES`` K4's launches by route.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .qsgd import (_aligned, _check, _on_card, quantize_plain, row_chunks,
                   sumsq_blocks, sumsq_plain)

__all__ = ["LAUNCHES", "ROUTES", "reset_launches", "FUSED_ROTATE_MAX_DIM",
           "K4_ONE_LAUNCH_MAX_N", "k4_route", "K5_CHUNK", "k5_cluster",
           "check_fused_s", "fused_encode",
           "fused_rotate_encode",
           "fused_encode_plain", "fused_rotate_encode_plain"]

#: kernel launches per wrapper (the plain versions never count)
LAUNCHES = {"fused_encode": 0, "fused_rotate_encode": 0}
#: K4's calls on the card by route (:func:`k4_route`)
ROUTES = {"one_launch": 0, "two_launch": 0}

#: largest power-of-two message K5 takes, as the JAX package's
#: single-VMEM-block limit (routing above it is unchanged: rotate, then K4)
FUSED_ROTATE_MAX_DIM = 1 << 15
#: the longest row K4 takes in one launch (128 blocks of K1's grid).  The
#: kernel holds rows of up to 2^22 (K1's grid gives each thread at most 4
#: vectors, csrc/fused_encode.cu kSlots), but every block of a row reads
#: the row's P partials, and from 256 blocks a row on the card measured it
#: slower than two launches (PERF.md, PR 16)
K4_ONE_LAUNCH_MAX_N = 1 << 19
#: coordinates one block of K5 holds at most (16 KiB of f32)
K5_CHUNK = 4096

_MAX_ROWS = 65535          # K4's grid.y limit
_MAX_SLOTS = 65535         # blocks of K4's one launch (csrc: kMaxSlots)
_PTR, _LL, _F32, _INT = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_int)
#: argument types of the C entry points in csrc/fused_encode.cu, stream
#: excluded
_SIGS = {
    "fused_encode": [_PTR, _PTR, _LL, _LL, _INT, _F32, _INT, _INT]
    + [_PTR] * 4,
    "fused_encode_capacity": [_PTR],
    "fused_rotate_encode": [_PTR, _PTR, _LL, _INT, _INT, ctypes.c_uint,
                            _F32, _F32, _INT] + [_PTR] * 3,
}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def check_fused_s(s: int, pack: bool):
    """The fused encodes' containers: int8 levels, int4 nibbles."""
    if s > 127:
        raise ValueError(f"the fused encode stores levels as int8 "
                         f"(s <= 127), got {s}")
    if pack and s > 7:
        raise ValueError(f"int4 nibble packing carries s <= 7, got {s}")


def k4_route(rows: int, n: int, capacity: int) -> str:
    """K4's route for a (rows, n) matrix on a card that holds ``capacity``
    blocks of the one-launch kernel at once: ``"one_launch"`` where n <=
    ``K4_ONE_LAUNCH_MAX_N`` and all rows x ``sumsq_blocks(n)`` blocks are
    resident together (its blocks wait for each other), else
    ``"two_launch"``.  A function of the shape and the card alone."""
    if n <= K4_ONE_LAUNCH_MAX_N and \
            rows * sumsq_blocks(n) <= min(capacity, _MAX_SLOTS):
        return "one_launch"
    return "two_launch"


_CAPACITY: dict = {}
_SCRATCH: dict = {}


def _card(device) -> torch.device:
    """``device`` with its index filled in (a bare "cuda" is the current
    card), so that each card has one entry in the caches below."""
    device = torch.device(device)
    return device if device.index is not None else torch.device(
        device.type, torch.cuda.current_device())


def _k4_scratch(device) -> torch.Tensor:
    """The one-launch route's exchange on ``device``: 1 + 65,535 int64
    zeros, allocated once and kept (word 0: the last launch's generation
    and a count of blocks, which each launch sets back to 0; then a slot a
    block, tagged with the generation that wrote it, so a CUDA-graph
    replay needs nothing reset).  K4 runs on PyTorch's current stream: two
    one-launch K4s in flight at once on different streams of one device
    would share it, which the port never does."""
    device = _card(device)
    t = _SCRATCH.get(device)
    if t is None:
        t = _SCRATCH[device] = torch.zeros(1 + _MAX_SLOTS, dtype=torch.int64,
                                           device=device)
    return t


def _capacity(device) -> int:
    """The one-launch kernel's resident blocks on ``device``
    (``fused_encode_capacity``), asked once per device."""
    device = _card(device)
    cap = _CAPACITY.get(device)
    if cap is None:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.launch("fused_encode", "fused_encode_capacity",
                         _SIGS["fused_encode_capacity"],
                         ctypes.addressof(blocks))
        cap = _CAPACITY[device] = blocks.value
    return cap


def k5_cluster(d: int) -> int:
    """K5's cluster size for a message of d coordinates: the blocks that
    hold it, ``K5_CHUNK`` coordinates each (1 up to 2^12, 8 at 2^15).  A
    function of d alone, so the norm's summation order never changes from
    call to call."""
    return max(1, d // K5_CHUNK)


def _check_pow2(d: int):
    if d < 2 or d & (d - 1) or d > FUSED_ROTATE_MAX_DIM:
        raise ValueError(f"the fused rotate encode takes a power-of-two "
                         f"message of 2..{FUSED_ROTATE_MAX_DIM} coordinates, "
                         f"got {d}")


def _check_pair(y, u, what: str):
    _check(y, f"{what} y", torch.float32, 2)
    _check(u, f"{what} u", torch.float32, 2)
    if u.shape != y.shape:
        raise ValueError(f"{what}: shapes y {tuple(y.shape)} u "
                         f"{tuple(u.shape)}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def fused_encode_plain(y: torch.Tensor, u: torch.Tensor, s, pack: bool):
    """(payload, norm) per row: K1's norm, K2's levels, then the nibble
    pack (``compress/wire.py``)."""
    from ..compress.wire import pack_int4
    _, norm, inv = sumsq_plain(y, s)
    lvl = quantize_plain(y, u, inv, s)
    return (pack_int4(lvl) if pack else lvl), norm


def fused_rotate_encode_plain(ypad: torch.Tensor, u: torch.Tensor, s,
                              seed: int, pack: bool):
    """``rotate`` each row, then :func:`fused_encode_plain`."""
    from ..compress.rotation import rotate
    return fused_encode_plain(rotate(ypad, seed), u, s, pack)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def fused_encode(y: torch.Tensor, u: torch.Tensor, s: int,
                 pack: bool = False):
    """K4: y, u (rows, n) f32 -> (payload, norm): payload (rows, ceil(n/2))
    packed int4 bytes when ``pack``, else (rows, n) int8 levels; norm
    (rows,) f32.  On the card each chunk of at most 65,535 rows is one
    call of the C entry point on :func:`k4_route`'s route."""
    _check_pair(y, u, "fused_encode")
    check_fused_s(int(s), pack)
    if not _on_card(y, u):
        return fused_encode_plain(y, u, s, pack)
    rows, n = y.shape
    if rows < 1 or n < 1:
        raise ValueError(f"fused_encode: bad shape {tuple(y.shape)}")
    P = sumsq_blocks(n)
    partials = torch.empty(min(rows, _MAX_ROWS) * P, dtype=torch.float32,
                           device=y.device)
    norm = torch.empty(rows, dtype=torch.float32, device=y.device)
    out = torch.empty((rows, (n + 1) // 2 if pack else n), dtype=torch.int8,
                      device=y.device)
    for r0, r in row_chunks(rows):     # partials reused: one stream
        route = k4_route(r, n, _capacity(y.device))
        build.launch("fused_encode", "fused_encode", _SIGS["fused_encode"],
                     y[r0].data_ptr(), u[r0].data_ptr(), r, n, P, float(s),
                     int(pack), int(route == "one_launch"),
                     partials.data_ptr(), _k4_scratch(y.device).data_ptr(),
                     norm[r0:].data_ptr(), out[r0].data_ptr())
        LAUNCHES["fused_encode"] += 1
        ROUTES[route] += 1
    return out, norm


def _k5_args(ypad: torch.Tensor, seed: int, s, pack: bool):
    """The scalar arguments of K5's C entry point after (ypad, u):
    rows, d, the cluster size, the seed as uint32, d^-1/2 in f32, s,
    pack."""
    rows, d = ypad.shape
    return (rows, d, k5_cluster(d), int(seed) & 0xFFFFFFFF,
            float(np.float32(d ** -0.5)), float(s), int(pack))


def fused_rotate_encode(ypad: torch.Tensor, u: torch.Tensor, s: int,
                        seed: int, pack: bool = False):
    """K5: ypad, u (rows, d) f32 with d a power of two in [2, 2^15] ->
    (payload, norm) of the rotated rows, as :func:`fused_encode`.  On the
    card an input off a 16-byte boundary (the kernel's vector loads) is
    copied to one first.  (The kernel's last pointer, a copy of the
    rotated rows, stays null here: only the smoke script's bitwise check
    of the FWHT passes one.)"""
    _check_pair(ypad, u, "fused_rotate_encode")
    check_fused_s(int(s), pack)
    rows, d = ypad.shape
    _check_pow2(d)
    if not _on_card(ypad, u):
        return fused_rotate_encode_plain(ypad, u, s, seed, pack)
    if not 1 <= rows * k5_cluster(d) < 2**31:
        raise ValueError(f"fused_rotate_encode: bad rows {rows}")
    ypad, u = _aligned(ypad), _aligned(u)
    norm = torch.empty(rows, dtype=torch.float32, device=ypad.device)
    out = torch.empty((rows, d // 2 if pack else d), dtype=torch.int8,
                      device=ypad.device)
    build.launch("fused_encode", "fused_rotate_encode",
                 _SIGS["fused_rotate_encode"], ypad.data_ptr(), u.data_ptr(),
                 *_k5_args(ypad, seed, s, pack), norm.data_ptr(),
                 out.data_ptr(), None)
    LAUNCHES["fused_rotate_encode"] += 1
    return out, norm
