"""The one-pass QSGD encodes of the "int4" payload, hand-written in CUDA for
Hopper (``csrc/fused_encode.cu``), with their launch wrappers and plain
PyTorch versions.

  K4 :func:`fused_encode`         replaces ``repro/kernels/qsgd.py``
                                  ``_fused_encode_kernel`` /
                                  ``fused_encode_call``
  K5 :func:`fused_rotate_encode`  replaces ``fused_rotate_encode_call``
                                  (its inner ``kernel``)

K4 is norm + quantize (+ int4 pack) of a (rows, n) matrix, one message per
row, in two launches: K1's partial sums of squares, then a quantize+pack
kernel that finishes the norm itself, so levels never reach device memory
and no host round trip separates the two.  It moves 12.5n bytes packed
(y twice, u once, n/2 out) and 13n unpacked, so device-memory bandwidth
bounds it at large n and launch latency at the model's D = 101,770.  K5 is
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
CPU; a CUDA tensor never falls back.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .qsgd import _check, _on_card, quantize_plain, sumsq_blocks, sumsq_plain

__all__ = ["LAUNCHES", "reset_launches", "FUSED_ROTATE_MAX_DIM",
           "K5_CHUNK", "k5_cluster", "check_fused_s", "fused_encode",
           "fused_rotate_encode",
           "fused_encode_plain", "fused_rotate_encode_plain"]

#: kernel launches per wrapper (the plain versions never count)
LAUNCHES = {"fused_encode": 0, "fused_rotate_encode": 0}

#: largest power-of-two message K5 takes, as the JAX package's
#: single-VMEM-block limit (routing above it is unchanged: rotate, then K4)
FUSED_ROTATE_MAX_DIM = 1 << 15
#: coordinates one block of K5 holds at most (16 KiB of f32)
K5_CHUNK = 4096

_MAX_ROWS = 65535          # K4's grid.y limit
_PTR, _LL, _F32, _INT = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_int)
#: argument types of the C entry points in csrc/fused_encode.cu, stream
#: excluded
_SIGS = {
    "fused_encode": [_PTR, _PTR, _LL, _LL, _INT, _F32, _INT] + [_PTR] * 3,
    "fused_rotate_encode": [_PTR, _PTR, _LL, _INT, _INT, ctypes.c_uint,
                            _F32, _F32, _INT] + [_PTR] * 3,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_fused_s(s: int, pack: bool):
    """The fused encodes' containers: int8 levels, int4 nibbles."""
    if s > 127:
        raise ValueError(f"the fused encode stores levels as int8 "
                         f"(s <= 127), got {s}")
    if pack and s > 7:
        raise ValueError(f"int4 nibble packing carries s <= 7, got {s}")


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
    (rows,) f32."""
    _check_pair(y, u, "fused_encode")
    check_fused_s(int(s), pack)
    if not _on_card(y, u):
        return fused_encode_plain(y, u, s, pack)
    rows, n = y.shape
    if not 1 <= rows <= _MAX_ROWS or n < 1:
        raise ValueError(f"fused_encode: bad shape {tuple(y.shape)}")
    P = sumsq_blocks(n)
    partials = torch.empty(rows * P, dtype=torch.float32, device=y.device)
    norm = torch.empty(rows, dtype=torch.float32, device=y.device)
    out = torch.empty((rows, (n + 1) // 2 if pack else n), dtype=torch.int8,
                      device=y.device)
    build.launch("fused_encode", "fused_encode", _SIGS["fused_encode"],
                 y.data_ptr(), u.data_ptr(), rows, n, P, float(s), int(pack),
                 partials.data_ptr(), norm.data_ptr(), out.data_ptr())
    LAUNCHES["fused_encode"] += 1
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
    card ypad and u start on a 16-byte boundary (the kernel's vector
    loads).  (The kernel's last pointer, a copy of the rotated rows, stays
    null here: only the smoke script's bitwise check of the FWHT passes
    one.)"""
    _check_pair(ypad, u, "fused_rotate_encode")
    check_fused_s(int(s), pack)
    rows, d = ypad.shape
    _check_pow2(d)
    if not _on_card(ypad, u):
        return fused_rotate_encode_plain(ypad, u, s, seed, pack)
    if not 1 <= rows * k5_cluster(d) < 2**31:
        raise ValueError(f"fused_rotate_encode: bad rows {rows}")
    if ypad.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("fused_rotate_encode: ypad and u must start on a "
                         "16-byte boundary")
    norm = torch.empty(rows, dtype=torch.float32, device=ypad.device)
    out = torch.empty((rows, d // 2 if pack else d), dtype=torch.int8,
                      device=ypad.device)
    build.launch("fused_encode", "fused_rotate_encode",
                 _SIGS["fused_rotate_encode"], ypad.data_ptr(), u.data_ptr(),
                 *_k5_args(ypad, seed, s, pack), norm.data_ptr(),
                 out.data_ptr(), None)
    LAUNCHES["fused_rotate_encode"] += 1
    return out, norm
