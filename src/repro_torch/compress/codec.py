"""Codec objects: the paper's abstract quantizer (q_s, M_s) made concrete.

A codec bundles the four things every layer of the system needs from the
quantizer ``Q(·; s)``:

  encode(tensor, noise) -> (levels, norm)   stochastic quantization
  decode(levels, norm)  -> tensor           dequantization
  wire_bits(dim)        -> M_s              bits per message (cost layer)
  variance_bound(dim)   -> q_s              Assumption-1 variance constant

Instances:
  :class:`QSGDCodec`     — the paper's Assumption-1 quantizer, one norm per
                           message; backend "torch" (reference math) or
                           "cuda" (the hand-written kernels; plain versions
                           on CPU tensors).
  :class:`RotatedQSGDCodec` — QSGD on the randomized-Hadamard rotated,
                           power-of-two padded message (GQFedWAvg's
                           quantizer).
  :class:`IdentityCodec` — s = ∞: exact passthrough, q_s = 0, recovering
                           PM-SGD / FedAvg / PR-SGD as special cases.

Every codec also has the one-pass payload pipeline ``encode_payload`` /
``decode_payload``: straight from the message to the bytes of its wire
(the fused kernels K4/K5 for "int4" on the "cuda" backend).

``make_codec`` is the single constructor the rest of the package uses.
The error-feedback codec and per-bucket norms are not ported yet
(ROADMAP.md, Queue 1, item 2), nor is the Elias coder of the "elias"
payload (item 9).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from .. import not_ported
from . import backends as B
from . import rotation as R
from . import wire as W

__all__ = ["Codec", "QSGDCodec", "IdentityCodec", "RotatedQSGDCodec",
           "CODEC_BACKENDS", "CODEC_KINDS", "make_codec", "variance_bound",
           "bits_per_message", "q_pair"]

#: "torch" = reference math, "cuda" = the QSGD kernels
CODEC_BACKENDS = ("torch", "cuda")
#: make_codec preconditioner variants ("kind" axis, orthogonal to backend/wire)
CODEC_KINDS = ("qsgd", "rotated")


def variance_bound(s: Optional[int], dim: int) -> float:
    """q_s of Assumption 1 for the QSGD quantizer: min(D/s^2, sqrt(D)/s)."""
    if s is None:
        return 0.0
    if s <= 0:
        raise ValueError(f"quantization parameter s must be positive, got {s}")
    return min(dim / s**2, math.sqrt(dim) / s)


def bits_per_message(s: Optional[int], dim: int) -> float:
    """M_s under the fixed-length "packed" wire model (monotone in s)."""
    return W.wire_bits(s, dim, wire="packed")


def q_pair(q_s0: float, q_sn: float) -> float:
    """q_{s0,sn} = q_{s0} + q_{sn} + q_{s0} q_{sn} (Theorem 1)."""
    return q_s0 + q_sn + q_s0 * q_sn


@dataclasses.dataclass(frozen=True)
class Codec:
    """Interface + shared conveniences.  ``wire`` only affects bit pricing
    — encode/decode math is wire-independent."""

    wire: str = "packed"

    @property
    def s(self) -> Optional[int]:
        raise NotImplementedError

    def encode(self, y: torch.Tensor, u: torch.Tensor):
        raise NotImplementedError

    def decode(self, levels: torch.Tensor, norm: torch.Tensor,
               dtype=torch.float32):
        raise NotImplementedError

    def decode_apply(self, x: torch.Tensor, levels: torch.Tensor,
                     norm: torch.Tensor, gamma) -> torch.Tensor:
        raise NotImplementedError

    def wire_bits(self, dim: int) -> float:
        raise NotImplementedError

    def variance_bound(self, dim: int) -> float:
        raise NotImplementedError

    @property
    def is_identity(self) -> bool:
        return self.s is None

    def padded_dim(self, dim: int) -> int:
        """Coordinates of the encoded message of a ``dim``-coordinate input
        (and of its noise ``u``)."""
        return dim

    def quantize_dequantize(self, y: torch.Tensor,
                            u: torch.Tensor) -> torch.Tensor:
        """Q(y; s) as a value, with the uniform noise ``u`` passed in."""
        lvl, norm = self.encode(y, u)
        return self.decode(lvl, norm, dtype=y.dtype)

    # -- the one-pass encode pipeline -----------------------------------
    def encode_payload(self, y: torch.Tensor, u: torch.Tensor):
        """Encode straight to the *wire payload* of ``self.wire`` in one
        pass: -> (payload, norm, nbits).

          wire "int4"  — packed nibble bytes, (..., ceil(m/2)) for messages
                         of m coordinates (the fused kernels on the "cuda"
                         backend);
          wire "elias" — not ported yet (ROADMAP.md, Queue 1, item 9);
          otherwise    — the levels themselves in their wire container.

        ``nbits`` is the payload's size on the wire (container bits,
        excluding the 32-bit norm words).  ``decode_payload`` is the exact
        inverse back to the dequantized tensor.
        """
        raise NotImplementedError

    def decode_payload(self, payload: torch.Tensor, norm: torch.Tensor,
                       n: int, dtype=torch.float32):
        """Inverse of :meth:`encode_payload`: payload -> dequantized tensor
        of ``n`` coordinates per message."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityCodec(Codec):
    """s = ∞: exact communication, q_s = 0, raw f32 on the wire."""

    @property
    def s(self) -> Optional[int]:
        return None

    def encode(self, y, u):
        return y, torch.ones(y.shape[:-1], dtype=torch.float32,
                             device=y.device)

    def decode(self, levels, norm, dtype=torch.float32):
        return levels.to(dtype)

    def decode_apply(self, x, levels, norm, gamma):
        return (x.to(torch.float32) + gamma * levels.to(torch.float32)) \
            .to(x.dtype)

    def wire_bits(self, dim: int) -> float:
        return W.wire_bits(None, dim, wire=self.wire)

    def variance_bound(self, dim: int) -> float:
        return 0.0

    def quantize_dequantize(self, y, u):
        return y

    def encode_payload(self, y, u):
        lvl, norm = self.encode(y, u)
        return lvl, norm, 32 * y.numel()

    def decode_payload(self, payload, norm, n, dtype=torch.float32):
        return payload[..., :n].to(dtype)


@dataclasses.dataclass(frozen=True)
class QSGDCodec(Codec):
    """The Assumption-1 QSGD quantizer with s levels, one L2 norm per
    message (the rows of the last dimension).

    Attributes:
      s_levels: quantization parameter s (>= 1).
      wire: pricing format (see :mod:`repro_torch.compress.wire`).
      backend: "torch" reference math or "cuda" kernels; levels are int8
        for s <= 127 and int32 above, on both.
    """

    s_levels: int = 1
    backend: str = "torch"

    def __post_init__(self):
        if self.s_levels <= 0:
            raise ValueError(f"s must be positive, got {self.s_levels}")
        cap = W.wire_max_s(self.wire)
        if cap is not None and self.s_levels > cap:
            raise ValueError(f"wire {self.wire!r} carries s <= {cap}, "
                             f"got {self.s_levels}")
        if self.backend not in CODEC_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {CODEC_BACKENDS}")

    @property
    def s(self) -> int:
        return self.s_levels

    @property
    def level_dtype(self):
        return B.level_dtype(self.s_levels)

    # -- encode / decode -------------------------------------------------
    def encode(self, y: torch.Tensor, u: torch.Tensor):
        """-> (levels shaped like y, norm per message)."""
        if self.backend == "cuda":
            return B.encode_cuda(y, self.s_levels, u)
        lvl, norm = B.encode(y, self.s_levels, u)
        return lvl.to(self.level_dtype), norm

    def decode(self, levels: torch.Tensor, norm: torch.Tensor,
               dtype=torch.float32):
        return B.decode(levels, norm, self.s_levels, dtype)

    def decode_apply(self, x: torch.Tensor, levels: torch.Tensor,
                     norm: torch.Tensor, gamma) -> torch.Tensor:
        """x + gamma * decode(levels) — the fused K3 on the cuda backend."""
        if self.backend == "cuda":
            return B.decode_apply_cuda(x, levels, norm, self.s_levels, gamma)
        upd = gamma * self.decode(levels, norm)
        return (x.to(torch.float32) + upd).to(x.dtype)

    # -- the one-pass encode pipeline ------------------------------------
    def _payload(self, lvl: torch.Tensor, norm: torch.Tensor):
        """(payload, norm, nbits) of levels already in their container."""
        return lvl, norm, int(W.level_bits(self.s_levels, self.wire)
                              * lvl.numel())

    def _check_payload_wire(self):
        if self.wire == "elias":
            raise not_ported("the Elias-omega payload coder (wire 'elias')",
                             9)

    def encode_payload(self, y: torch.Tensor, u: torch.Tensor):
        self._check_payload_wire()
        if self.wire != "int4":
            return self._payload(*self.encode(y, u))
        if self.backend == "cuda":
            packed, norm = B.encode_fused(y, self.s_levels, u, pack=True)
        else:
            packed, norm = B.encode_fused_torch(y, self.s_levels, u,
                                                pack=True)
        return packed, norm, 8 * packed.numel()

    def _payload_levels(self, payload: torch.Tensor, n: int):
        self._check_payload_wire()
        if self.wire == "int4":
            return W.unpack_int4(payload, n)
        return payload[..., :n]

    def decode_payload(self, payload: torch.Tensor, norm: torch.Tensor,
                       n: int, dtype=torch.float32):
        return self.decode(self._payload_levels(payload, n), norm, dtype)

    # -- cost-layer views ------------------------------------------------
    def wire_bits(self, dim: int) -> float:
        return W.wire_bits(self.s_levels, dim, wire=self.wire)

    def variance_bound(self, dim: int) -> float:
        return variance_bound(self.s_levels, dim)


@dataclasses.dataclass(frozen=True)
class RotatedQSGDCodec(QSGDCodec):
    """Rotation-preconditioned QSGD (GQFedWAvg's quantizer).

    Encodes ``R y`` with ``R = (1/sqrt(d)) H_d D_sigma`` the randomized
    Hadamard rotation (:mod:`repro_torch.compress.rotation`) and decodes
    with the exact inverse ``R^T``; ``R`` is orthonormal, so Assumption 1
    holds for the rotated message verbatim.

    Shape contract: the rotation pads each message to ``d' =
    next_pow2(n)``, so ``encode`` returns levels of length ``d'`` (that is
    the message: the wire moves the padded levels plus the 32-bit rotation
    seed, and ``wire_bits`` prices exactly that), ``u`` has length ``d'``,
    and ``decode`` — like ``decode_payload``, whose ``n`` is ``d'`` —
    returns the unrotated padded vector; ``quantize_dequantize`` returns
    the caller's shape.

    On the "cuda" backend ``encode`` is ``rotate`` then K1/K2 (int32
    levels above s = 127, so the runtime's s = 2^14 runs through it);
    ``decode_apply`` stays plain PyTorch — K3 cannot apply a rotated
    update.
    """

    seed: int = 0

    def padded_dim(self, dim: int) -> int:
        return R.next_pow2(dim)

    # -- encode / decode -------------------------------------------------
    def encode(self, y: torch.Tensor, u: torch.Tensor):
        r = R.rotate(y, self.seed)
        return super().encode(r, u)

    def decode(self, levels: torch.Tensor, norm: torch.Tensor,
               dtype=torch.float32):
        dq = B.decode(levels, norm, self.s_levels, torch.float32)
        return R.unrotate(dq, self.seed, dq.shape[-1]).to(dtype)

    def decode_apply(self, x: torch.Tensor, levels: torch.Tensor,
                     norm: torch.Tensor, gamma) -> torch.Tensor:
        upd = gamma * self.decode(levels, norm)[..., :x.shape[-1]]
        return (x.to(torch.float32) + upd).to(x.dtype)

    def quantize_dequantize(self, y: torch.Tensor,
                            u: torch.Tensor) -> torch.Tensor:
        lvl, norm = self.encode(y, u)
        return self.decode(lvl, norm)[..., :y.shape[-1]].to(y.dtype)

    # -- the one-pass encode pipeline ------------------------------------
    def encode_payload(self, y: torch.Tensor, u: torch.Tensor):
        """Same contract as the base, on the *rotated padded* message: K5
        folds the rotation into the quantize pass (K4 after a separate
        rotation above 2^15 coordinates)."""
        self._check_payload_wire()
        if self.wire != "int4":
            return self._payload(*self.encode(y, u))
        if self.backend == "cuda":
            packed, norm = B.encode_rotated_fused(y, self.s_levels, u,
                                                  self.seed, pack=True)
        else:
            packed, norm = B.encode_fused_torch(R.rotate(y, self.seed),
                                                self.s_levels, u, pack=True)
        return packed, norm, 8 * packed.numel()

    # -- cost-layer views ------------------------------------------------
    def wire_bits(self, dim: int) -> float:
        """The padded levels plus the 32-bit rotation seed."""
        return W.wire_bits(self.s_levels, self.padded_dim(dim),
                           wire=self.wire) + 32.0

    def variance_bound(self, dim: int) -> float:
        """Assumption 1 at the rotated message's dimension."""
        return variance_bound(self.s_levels, self.padded_dim(dim))


@functools.lru_cache(maxsize=1024)
def make_codec(s: Optional[int], wire: str = "packed",
               bucket: Optional[int] = None, backend: str = "torch",
               kind: str = "qsgd", seed: int = 0) -> Codec:
    """The one constructor: s=None -> IdentityCodec, else QSGDCodec (or the
    rotation-preconditioned variant for ``kind="rotated"``, whose signs
    come from ``seed``).

    Codecs are frozen/stateless, so instances are memoized — the cost layer
    reconstructs them inside the GIA inner loop and must not pay object
    churn there.
    """
    if kind not in CODEC_KINDS:
        raise ValueError(f"unknown codec kind {kind!r}; "
                         f"expected one of {CODEC_KINDS}")
    if bucket is not None:
        raise not_ported("per-bucket-norm quantization (bucket / q_dim)", 2)
    if s is None:
        return IdentityCodec(wire=wire)
    if kind == "rotated":
        return RotatedQSGDCodec(wire=wire, s_levels=int(s), backend=backend,
                                seed=int(seed))
    return QSGDCodec(wire=wire, s_levels=int(s), backend=backend)
