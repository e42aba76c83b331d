"""Wire formats, cost-model-consistent bit accounting, and the int4 nibble
pack of the "int4" payload.

A *codec* decides how a tensor becomes (levels, norm); a *wire format*
decides how those travel and therefore how many bits one message costs.
The same table serves both sides of the system:

  * the distributed runtime's aggregation transports (``fed/runtime.py``
    in the JAX package) validate their quantizers against
    :func:`wire_max_s` and move exactly the payloads priced here;
  * :class:`repro_torch.core.cost.EdgeSystem` derives ``M_s`` from
    :func:`wire_bits` via the codec, so the GIA/CGP optimizer provably
    prices the same bytes the runtime sends.

Formats:
  "packed" — fixed-length code: 32-bit norm per bucket plus, per coordinate,
             a sign bit and ceil(log2(s+1)) level bits.  The paper's
             monotone-in-s cost model (arbitrary s); not a runtime transport.
  "f32"    — dequantized values as f32 (paper-faithful math on the wire).
  "rs_ag"  — same f32 payload moved as reduce-scatter + all-gather.
  "int8"   — raw int8 levels + f32 norms; s <= 127.
  "int4"   — two levels packed per byte + f32 norms; s <= 7 (the paper's
             low-s regime), 2x fewer aggregation bytes than int8.
  "elias"  — Elias-omega gap-coded levels + f32 norms
             (:mod:`repro_torch.compress.elias`): one omega(gap) +
             omega(|level|) + sign triple per *nonzero* level, so the message costs
             min(d * omega_max_bits(s) + term, QSGD-Thm-3.2 expected bits)
             — the paper's tighter M_s bound.  Unbounded s for *pricing*
             (worst-case cost grows with log s, e.g. 24 bits/coordinate at
             s = 2^14); the *runtime* coder reads levels from an int8
             container, so the fed transport carries s <= 127 (validated
             by FedConfig, not here).  An exact (s = None) message rides
             raw f32, like every non-packing wire.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import elias as E

__all__ = [
    "WIRE_FORMATS", "RUNTIME_WIRES", "wire_max_s", "level_bits",
    "wire_bits", "pack_int4", "unpack_int4",
]

#: every format the bit model prices
WIRE_FORMATS = ("packed", "f32", "int8", "int4", "rs_ag", "elias")
#: the subset the fed runtime accepts as aggregation transports
RUNTIME_WIRES = ("f32", "int8", "int4", "rs_ag", "elias")

#: largest s each format can carry (None = unbounded)
_WIRE_MAX_S = {"packed": None, "f32": 127, "rs_ag": 127,
               "int8": 127, "int4": 7, "elias": None}


def wire_max_s(wire: str) -> Optional[int]:
    """Largest quantization parameter the format's container can hold.

    f32/rs_ag move f32 *values*, but the runtime still materializes levels
    in an int8 container first, hence the shared 127 cap there.
    """
    if wire not in _WIRE_MAX_S:
        raise ValueError(f"unknown wire format {wire!r}; "
                         f"expected one of {WIRE_FORMATS}")
    return _WIRE_MAX_S[wire]


def level_bits(s: Optional[int], wire: str) -> float:
    """Bits one coordinate occupies on the wire.  For the variable-length
    "elias" format this is the *worst-case* per-coordinate cost (unit gap
    + largest magnitude codeword + sign); :func:`wire_bits` prices the
    tighter min(worst-case, expected) total."""
    if s is None or wire in ("f32", "rs_ag"):
        return 32.0
    if wire == "packed":
        return 1.0 + math.ceil(math.log2(s + 1))
    if wire == "int8":
        return 8.0
    if wire == "int4":
        return 4.0
    if wire == "elias":
        return float(E.omega_max_bits(s))
    raise ValueError(f"unknown wire format {wire!r}")


def wire_bits(s: Optional[int], dim: int, wire: str = "packed",
              bucket: Optional[int] = None) -> float:
    """M_s: bits to represent one D-dimensional message on this wire.

    ``bucket`` = per-bucket-norm quantization (QSGD bucketing): each bucket
    contributes its own 32-bit norm word.  Raises for (s, wire) pairs the
    transport cannot carry, so the cost layer can never price a message the
    runtime would reject.
    """
    cap = wire_max_s(wire)
    if s is not None and s <= 0:
        raise ValueError(f"quantization parameter s must be positive, got {s}")
    if s is not None and cap is not None and s > cap:
        raise ValueError(f"wire format {wire!r} carries s <= {cap}, got {s}")
    if s is None:
        if wire == "int4":
            # mirror the runtime: the packing wire cannot carry an exact
            # (s = infinity) f32 passthrough, so refuse to price one
            raise ValueError("wire format 'int4' packs quantized levels and "
                             "cannot carry exact (s=None) messages")
        return 32.0 * (dim + 1)  # raw f32 vector + norm word
    if wire in ("f32", "rs_ag"):
        return 32.0 * dim        # values on the wire; norm already folded in
    n_buckets = 1 if bucket is None else -(-dim // bucket)
    if wire == "elias":
        # gap-coded levels: min(worst-case, QSGD-Thm-3.2 expected) — with
        # bucketing the expectation applies per bucket (each bucket is
        # normalized by its own norm), the stream itself stays one run
        if bucket is None:
            lvl_bits = E.payload_bits(s, dim)
        else:
            lvl_bits = min(float(dim) * E.omega_max_bits(s) + E._TERM_BITS,
                           n_buckets * E.expected_code_bits(s, bucket))
        return 32.0 * n_buckets + lvl_bits
    return 32.0 * n_buckets + dim * level_bits(s, wire)


# ---------------------------------------------------------------------------
# int4 packing: two signed nibbles per int8 byte (levels in [-7, 7]), along
# the last dimension (one message per row; a 1-D input packs exactly as the
# JAX package's flat ``pack_int4``)
# ---------------------------------------------------------------------------
def pack_int4(levels: torch.Tensor) -> torch.Tensor:
    """Pack int levels in [-7, 7] into ceil(n/2) bytes per row, lo nibble
    first; an odd row's last high nibble is 0.  (..., n) -> (..., ceil(n/2))
    int8."""
    v = levels.to(torch.int32) & 0x0F
    if v.shape[-1] % 2:
        v = torch.nn.functional.pad(v, (0, 1))
    return (v[..., 0::2] | (v[..., 1::2] << 4)).to(torch.uint8) \
        .view(torch.int8)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., ceil(n/2)) bytes -> (..., n) int8
    levels, nibbles above 7 sign-extended."""
    p = packed.to(torch.int32) & 0xFF
    nib = torch.stack([p & 0x0F, p >> 4], dim=-1) \
        .reshape(*p.shape[:-1], -1)[..., :n]
    return torch.where(nib > 7, nib - 16, nib).to(torch.int8)
