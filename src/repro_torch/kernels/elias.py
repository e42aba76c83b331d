"""The Elias-omega payload decode, hand-written in CUDA for Hopper
(``csrc/elias.cu``), with its launch wrapper and plain version.

  :func:`elias_decode`  replaces no TPU kernel: the JAX package decodes
                        with a ``lax.scan`` in jnp
                        (``repro/compress/elias.py`` ``decode_levels``)

The stream is a prefix code, so one thread walks each message's stream
(one block a row, whose threads first zero the row): the kernel is bound
by the latency of that chain of dependent steps, not by bytes.  The plain
version is the same walk in Python on the host, for a CPU tensor only.
The wrapper runs the kernel for a CUDA tensor — a stream on the card is
never decoded on the host — and ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .qsgd import _on_card

__all__ = ["LAUNCHES", "reset_launches", "elias_decode",
           "elias_decode_plain"]

#: kernel launches of the wrapper (the plain version never counts)
LAUNCHES = {"elias_decode": 0}

_MAX_ROWS = 2**31 - 1      # grid.x limit, one block a row
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
_SIG = [_PTR, _LL, _LL, _LL, _PTR]


def reset_launches() -> None:
    LAUNCHES["elias_decode"] = 0


def _decode_row(ws: list, d: int, out: np.ndarray) -> None:
    """The kernel's walk over one row's words (Python ints in [0, 2^32)),
    writing the nonzero levels into the zeroed ``out``."""
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
        out[pos] = -m if neg else m


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
    if rows > _MAX_ROWS:
        raise ValueError(f"elias_decode: {rows} rows")
    build.launch("elias", "elias_decode", _SIG, w2.data_ptr(), rows, cap, d,
                 out.data_ptr())
    LAUNCHES["elias_decode"] += 1
    return out.reshape(*lead, d)
