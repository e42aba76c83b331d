"""Elias-omega coding of QSGD levels — the "elias" wire format: the
pricing closed forms :func:`repro_torch.compress.wire.wire_bits` calls
(pure Python, the same arithmetic as the JAX package's
``compress/elias.py``) and the runtime coder.

QSGD's communication theorem (arXiv 1610.02132, Thm 3.2) prices a message
with positional gap coding of the nonzero levels:

  stream := [ omega(gap) omega(|level|) sign ]*  omega(terminal-gap)

one triple per **nonzero** level, ``gap`` the distance to the previous
nonzero coordinate (>= 1), the terminal gap pointing one past the end, so
the stream is self-delimiting given d.

Bit layout (the JAX package's): transmitted bit ``j`` of a codeword lands
at stream bit ``offset + j`` (omega groups MSB-first within the
codeword); stream bit ``b`` lives in ``words[b >> 5]`` at bit ``b & 31``.
torch's ``uint32`` has few kernels, so the coder carries its bit plumbing
in ``int64`` and hands back ``int32`` words whose 32 bits are the JAX
package's ``uint32`` words.

:func:`encode_levels` is vectorized PyTorch (cummax gaps, cumsum offsets,
three scatter-adds), the same on the CPU and the card.  The rows of the
last axis are messages, one stream each; a 1-D input is the JAX package's
call.  :func:`decode_levels` is a sequential prefix-code walk: on the card
the hand-written ``elias_decode`` kernel (:mod:`repro_torch.kernels.elias`),
on the CPU its plain version.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

__all__ = ["MAX_COORD_BITS", "MAX_RUNTIME_S", "omega_length",
           "omega_max_bits", "expected_code_bits", "payload_bits",
           "encode_levels", "decode_levels", "stream_bits", "word_capacity"]

#: worst-case stream bits one coordinate can cost at the runtime cap
#: (unit gap = 1 bit, |level| <= 127 -> <= 13-bit magnitude, sign = 1)
MAX_COORD_BITS = 15
#: the runtime coder reads levels from an int8 container, like every other
#: level transport (pricing via :func:`payload_bits` is unbounded in s)
MAX_RUNTIME_S = 127
#: any terminal-gap codeword for vectors below 2^24 coordinates fits this
_TERM_BITS = 36


def _omega_bits(n: int):
    """Elias-omega codeword of n >= 1, in transmission order."""
    if n < 1:
        raise ValueError(f"omega codes positive integers, got {n}")
    bits = [0]
    while n > 1:
        group = [int(c) for c in bin(n)[2:]]
        bits = group + bits
        n = len(group) - 1
    return bits


def omega_length(n: int) -> int:
    """Codeword length (bits) of the Elias-omega code of n >= 1."""
    return len(_omega_bits(n))


@functools.lru_cache(maxsize=None)
def omega_max_bits(s: int) -> int:
    """Worst-case stream bits one coordinate costs at quantizer s: a unit
    gap (1 bit) + the largest magnitude codeword over |level| in [1, s]
    (omega length is not monotone — powers of two jump — so take the max)
    + the sign bit.  Monotone in s, like every fixed-length wire's
    bits/coordinate."""
    if s <= 0:
        raise ValueError(f"quantization parameter s must be positive, got {s}")
    return 2 + max(omega_length(m) for m in range(1, s + 1))


def expected_code_bits(s: int, d: int) -> float:
    """QSGD Thm 3.2's closed-form expected payload (bits, excluding the norm
    word): at most s(s + sqrt(d)) nonzero levels travel, each costing
    O(log(d / #nonzeros)) positional+magnitude bits under a universal code:

        s(s + sqrt(d)) * (3 + 1.5 * log2(2(s^2 + d) / (s(s + sqrt(d)))))
    """
    if s <= 0:
        raise ValueError(f"quantization parameter s must be positive, got {s}")
    nz = s * (s + math.sqrt(d))
    return nz * (3.0 + 1.5 * math.log2(2.0 * (s * s + d) / nz))


def payload_bits(s: int, d: int) -> float:
    """min(worst-case, expected-sparse) total level bits for d coordinates —
    both are valid message-size bounds, so the cost model prices the tighter
    one (dense high-s messages take d * omega_max_bits; sparse low-s
    messages the Thm-3.2 term)."""
    return min(float(d) * omega_max_bits(s) + _TERM_BITS,
               expected_code_bits(s, d))


def word_capacity(d: int) -> int:
    """Static 32-bit word count that always holds d coded levels (the
    realized stream fits ``MAX_COORD_BITS * d + _TERM_BITS``; +2 words of
    slack so the 3-word scatter never runs off the end)."""
    return (MAX_COORD_BITS * d + _TERM_BITS + 31) // 32 + 2


# ---------------------------------------------------------------------------
# vectorized bit plumbing (int64 tensors holding unsigned values)
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """Bit length of v in [1, 2^32) (branch-free)."""
    ln = torch.zeros_like(v)
    x = v
    for k in (16, 8, 4, 2, 1):
        t = x >> k
        big = t > 0
        ln = ln + big * k
        x = torch.where(big, t, x)
    return ln + 1


def _rev32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of the low 32 bits (group value <-> MSB-first
    transmission)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0xFFFF) << 16) | (x >> 16)


def _omega_parts(v: torch.Tensor):
    """Elias-omega codeword of v in [1, 2^25): -> (code, nbits), transmitted
    bit j at bit j of the int64 ``code`` (at most 35 bits)."""
    chain = [v]
    for _ in range(4):  # values < 2^25 terminate in <= 4 length steps
        p = chain[-1]
        chain.append(torch.where(p > 1, _bitlen(p) - 1, torch.ones_like(p)))
    code = torch.zeros_like(v)
    off = torch.zeros_like(v)
    for grp_val in reversed(chain):  # the outermost length group goes first
        ln = torch.where(grp_val > 1, _bitlen(grp_val),
                         torch.zeros_like(grp_val))
        code = code | ((_rev32(grp_val) >> (32 - ln)) << off)
        off = off + ln
    return code, off + 1  # the terminal zero bit


def _gaps(lv: torch.Tensor):
    """-> (nonzero mask, gap to the previous nonzero, terminal gap) per row
    of int64 levels (..., d); gaps are >= 1."""
    d = lv.shape[-1]
    nz = lv != 0
    pos = torch.arange(d, dtype=torch.int64, device=lv.device)
    run = torch.cummax(torch.where(nz, pos, torch.full_like(lv, -1)),
                       dim=-1).values
    prev = torch.cat([torch.full_like(run[..., :1], -1), run[..., :-1]],
                     dim=-1)
    return nz, pos - prev, d - run[..., -1]


def _codewords(lv: torch.Tensor):
    """Per coordinate of int64 levels (..., d): the triple omega(gap)
    omega(|level|) sign as one int64 code (<= 49 bits) and its length, 0
    for a zero level; and the terminal gap's codeword per row."""
    nz, gap, tgap = _gaps(lv)
    gcode, gn = _omega_parts(gap)
    mcode, mn = _omega_parts(torch.clamp_min(lv.abs(), 1))
    nb = gn + mn
    code = gcode | (mcode << gn) | ((lv < 0).to(torch.int64) << nb)
    nb = nb + 1
    zero = torch.zeros_like(code)
    return (torch.where(nz, code, zero), torch.where(nz, nb, zero),
            *_omega_parts(tgap))


def _rows(levels: torch.Tensor) -> torch.Tensor:
    """(..., d) levels -> (rows, d) int64 (rows >= 1 unless d = 0)."""
    d = levels.shape[-1]
    if d >= (1 << 24):
        raise ValueError(f"elias runtime coder handles < 2^24 coords, "
                         f"got {d}")
    return levels.to(torch.int64).reshape(-1, d) if d else None


# ---------------------------------------------------------------------------
# the runtime coder
# ---------------------------------------------------------------------------
def encode_levels(levels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """levels (..., d) int in [-127, 127] -> (words, nbits): ``words``
    (..., ``word_capacity(d)``) int32 whose bits are the JAX package's
    uint32 words, ``nbits`` (...) int32 the realized stream length of each
    row (the payload on the wire is its first ceil(nbits/32) words)."""
    lead, dev = levels.shape[:-1], levels.device
    lv = _rows(levels)
    if lv is None:   # d = 0: just the terminal gap omega(1), a single 0 bit
        return (torch.zeros(*lead, word_capacity(0), dtype=torch.int32,
                            device=dev),
                torch.ones(lead, dtype=torch.int32, device=dev))
    R, d = lv.shape
    cap = word_capacity(d)
    code, nb, tcode, tn = _codewords(lv)
    ends = torch.cumsum(nb, dim=-1)
    offs = torch.cat([ends - nb, ends[:, -1:]], dim=-1)
    code = torch.cat([code, tcode[:, None]], dim=-1)
    total = ends[:, -1] + tn
    # each code spans at most three 32-bit words; the codes cover disjoint
    # bits, so adding them is OR-ing them
    sh = offs & 31
    lo, hi = code & _M32, code >> 32
    w0 = (lo << sh) & _M32
    w1 = (lo >> (32 - sh)) | ((hi << sh) & _M32)
    w2 = hi >> (32 - sh)
    idx = (offs >> 5) + cap * torch.arange(R, device=dev)[:, None]
    words = torch.zeros(R * cap, dtype=torch.int64, device=dev)
    for k, w in enumerate((w0, w1, w2)):
        words.index_add_(0, (idx + k).reshape(-1), w.reshape(-1))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return (words.to(torch.int32).reshape(*lead, cap),
            total.to(torch.int32).reshape(lead))


def stream_bits(levels: torch.Tensor) -> torch.Tensor:
    """Realized stream length (bits, int32, one per row) without
    materializing the words."""
    lead = levels.shape[:-1]
    lv = _rows(levels)
    if lv is None:
        return torch.ones(lead, dtype=torch.int32, device=levels.device)
    _, nb, _, tn = _codewords(lv)
    return (nb.sum(dim=-1) + tn).to(torch.int32).reshape(lead)


def decode_levels(words: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`encode_levels`: words (..., capacity) int32 ->
    int8 levels (..., d).  The ``elias_decode`` kernel on the card, its
    plain walk on the CPU."""
    from ..kernels.elias import elias_decode
    return elias_decode(words, int(d))
