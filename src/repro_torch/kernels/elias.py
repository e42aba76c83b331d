"""The Elias-omega payload decode, hand-written in CUDA for Hopper
(``csrc/elias.cu``), with its launch wrapper and plain version.

  :func:`elias_decode`  replaces no TPU kernel: the JAX package decodes
                        with a ``lax.scan`` in jnp
                        (``repro/compress/elias.py`` ``decode_levels``)

The stream is a prefix code, so a walk knows where a triple starts only
once it has read the one before.  The kernel decodes each row in parallel
over chunks of ``CHUNK_BITS`` bits: walks of every chunk from each of the
``WINDOW`` offsets where its first triple can start (an encoder triple is
at most 50 bits), composed into tables of ``SEGMENT_CHUNKS`` chunks in a
block and resolved along the row by the row's last table block, then one
walk a chunk from its true entry, writing its levels.  Past a row's last
nonzero word the walk would decode +1 at every position up to d: that
tail is written in closed form.  ``KERNELS_PER_CALL`` launches (for each
65,535 rows), no host synchronisation; the scratch comes from
``torch.empty``.  A row whose chain leaves the window or meets a codeword
group longer than 32 bits (words no encoder produced) is finished by the
sequential walk inside the last launch and counted by
:func:`malformed_rows`.

The plain version is the sequential walk in Python on the host, for a CPU
tensor only.  The wrapper runs the kernel for a CUDA tensor — a stream on
the card is never decoded on the host — and ``LAUNCHES`` counts its calls
(one a decode, whatever the number of CUDA launches in it).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .qsgd import _on_card

__all__ = ["LAUNCHES", "reset_launches", "elias_decode",
           "elias_decode_plain", "malformed_rows", "CHUNK_BITS", "WINDOW",
           "SEGMENT_CHUNKS", "KERNELS_PER_CALL"]

#: kernel calls of the wrapper (the plain version never counts)
LAUNCHES = {"elias_decode": 0}

#: bits a chunk; candidate entry offsets a chunk (>= the 50 bits of the
#: longest encoder triple); chunks a segment, composed in one block.
#: ``csrc/elias.cu`` holds the same values and refuses others.
CHUNK_BITS = 128
WINDOW = 50
SEGMENT_CHUNKS = 8
#: CUDA launches of one call (extent, tables with the resolve, decode)
KERNELS_PER_CALL = 3

_LIMIT = 2**31             # cap and d stay below it
_PTR, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIG = [_PTR, _LL, _LL, _LL, _I, _I, _I, _PTR, _PTR, _PTR, _PTR]
_MAX_ROWS = 65535          # rows a launch (grid.y); more go in turns
_MALFORMED: dict = {}
_TICKETS: dict = {}


def reset_launches() -> None:
    LAUNCHES["elias_decode"] = 0


def _malformed(device: torch.device) -> torch.Tensor:
    """The device's count of rows decoded by the sequential walk (one
    int64, allocated on first use and kept; the first call on a device
    must come before any CUDA-graph capture)."""
    t = _MALFORMED.get(device)
    if t is None:
        t = torch.zeros(1, dtype=torch.int64, device=device)
        _MALFORMED[device] = t
    return t


def _tickets(device: torch.device) -> torch.Tensor:
    """The table launch's per-row tickets on ``device``: ``_MAX_ROWS``
    int32 zeros, allocated once and kept; the last block of a row sets its
    ticket back to 0 (so a CUDA-graph replay finds them zero too).  Two
    decodes in flight at once on different streams of one device would
    share them, which the port never does."""
    t = _TICKETS.get(device)
    if t is None:
        t = torch.zeros(_MAX_ROWS, dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def malformed_rows(device) -> int:
    """Rows the kernel has finished by its sequential walk on ``device``
    since the process started (0 on every encoder stream).  Reads the
    device: not for a decode's path."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return int(_malformed(dev).item())


def _decode_row(ws: list, d: int, out: np.ndarray) -> None:
    """The sequential walk over one row's words (Python ints in [0, 2^32)),
    writing the nonzero levels into the zeroed ``out``: the kernel's
    result on every input (a level wraps to int8, as the kernel casts)."""
    cap = len(ws)
    st = [0, 0, 0]          # unread bits, their count, the next word

    def peek() -> int:
        while st[1] <= 32:
            st[0] |= (ws[st[2]] if st[2] < cap else 0) << st[1]
            st[1] += 32
            st[2] += 1
        return st[0]

    def skip(k: int) -> None:
        st[0] >>= k
        st[1] -= k

    def omega() -> int:
        n = 1
        while True:
            win = peek()
            if not win & 1:
                skip(1)
                return n
            ln = n + 1
            if ln > 32:
                return 0
            n = int(format(win & ((1 << ln) - 1), f"0{ln}b")[::-1], 2)
            skip(ln)

    pos = -1
    while True:
        g = omega()
        if g == 0 or pos + g >= d:
            return
        pos += g
        m = omega()
        neg = peek() & 1
        skip(1)
        v = (-m if neg else m) & 0xFF        # the kernel's int8 cast
        out[pos] = v - 256 if v > 127 else v


def elias_decode_plain(words: torch.Tensor, d: int) -> torch.Tensor:
    """words (..., cap) int32 -> int8 levels (..., d), on the host."""
    lead, cap = words.shape[:-1], words.shape[-1]
    w = (words.reshape(-1, cap).numpy().astype(np.int64) & 0xFFFFFFFF)
    out = np.zeros((w.shape[0], d), np.int8)
    for r in range(w.shape[0]):
        _decode_row(w[r].tolist(), d, out[r])
    return torch.from_numpy(out).reshape(*lead, d)


def elias_decode(words: torch.Tensor, d: int) -> torch.Tensor:
    """words (..., cap) int32, one stream a row (``compress/elias.py``
    ``encode_levels``) -> int8 levels (..., d)."""
    if words.dtype != torch.int32 or words.dim() < 1 \
            or words.shape[-1] < 1 or d < 0:
        raise ValueError(f"elias_decode: want int32 words (..., cap >= 1) "
                         f"and d >= 0, got {tuple(words.shape)} "
                         f"{words.dtype}, d={d}")
    if not _on_card(words):
        return elias_decode_plain(words, d)
    lead, cap = words.shape[:-1], words.shape[-1]
    w2 = words.reshape(-1, cap).contiguous()
    rows = w2.shape[0]
    out = torch.empty((rows, d), dtype=torch.int8, device=words.device)
    if d == 0 or rows == 0:
        return out.reshape(*lead, d)
    if cap >= _LIMIT or d >= _LIMIT:
        raise ValueError(f"elias_decode: cap {cap} and d {d} must stay "
                         f"below 2^31")
    lib = build.load("elias")
    lib.elias_decode_scratch_bytes.argtypes = [_LL, _LL]
    lib.elias_decode_scratch_bytes.restype = _LL
    scratch = torch.empty(lib.elias_decode_scratch_bytes(rows, cap),
                          dtype=torch.uint8, device=words.device)
    build.launch("elias", "elias_decode", _SIG, w2.data_ptr(), rows, cap, d,
                 CHUNK_BITS, WINDOW, SEGMENT_CHUNKS, scratch.data_ptr(),
                 _tickets(words.device).data_ptr(),
                 _malformed(words.device).data_ptr(), out.data_ptr())
    LAUNCHES["elias_decode"] += 1
    return out.reshape(*lead, d)
