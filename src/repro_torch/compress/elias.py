"""Elias-omega pricing for the "elias" wire format — the closed forms
:func:`repro_torch.compress.wire.wire_bits` calls (pure Python, the same
arithmetic as the JAX package's ``compress/elias.py``).

QSGD's communication theorem (arXiv 1610.02132, Thm 3.2) prices a message
with positional gap coding of the nonzero levels:

  stream := [ omega(gap) omega(|level|) sign ]*  omega(terminal-gap)

The coder itself (``encode_levels`` / ``decode_levels``) comes with the
distributed runtime (ROADMAP.md, Queue 1, item 9).
"""
from __future__ import annotations

import functools
import math

__all__ = ["MAX_COORD_BITS", "MAX_RUNTIME_S", "omega_length",
           "omega_max_bits", "expected_code_bits", "payload_bits"]

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
