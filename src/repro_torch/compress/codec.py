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
  :class:`IdentityCodec` — s = ∞: exact passthrough, q_s = 0, recovering
                           PM-SGD / FedAvg / PR-SGD as special cases.

``make_codec`` is the single constructor the rest of the package uses.
The rotated and error-feedback codecs and per-bucket norms are not ported
yet (ROADMAP.md, Queue 1, item 2).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from .. import not_ported
from . import backends as B
from . import wire as W

__all__ = ["Codec", "QSGDCodec", "IdentityCodec", "CODEC_BACKENDS",
           "make_codec", "variance_bound", "bits_per_message", "q_pair"]

#: "torch" = reference math, "cuda" = the QSGD kernels
CODEC_BACKENDS = ("torch", "cuda")


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

    def quantize_dequantize(self, y: torch.Tensor,
                            u: torch.Tensor) -> torch.Tensor:
        """Q(y; s) as a value, with the uniform noise ``u`` passed in."""
        lvl, norm = self.encode(y, u)
        return self.decode(lvl, norm, dtype=y.dtype)


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

    # -- cost-layer views ------------------------------------------------
    def wire_bits(self, dim: int) -> float:
        return W.wire_bits(self.s_levels, dim, wire=self.wire)

    def variance_bound(self, dim: int) -> float:
        return variance_bound(self.s_levels, dim)


@functools.lru_cache(maxsize=1024)
def make_codec(s: Optional[int], wire: str = "packed",
               bucket: Optional[int] = None, backend: str = "torch",
               kind: str = "qsgd") -> Codec:
    """The one constructor: s=None -> IdentityCodec, else QSGDCodec.

    Codecs are frozen/stateless, so instances are memoized — the cost layer
    reconstructs them inside the GIA inner loop and must not pay object
    churn there.
    """
    if kind != "qsgd":
        raise not_ported(f"codec kind {kind!r}", 2)
    if bucket is not None:
        raise not_ported("per-bucket-norm quantization (bucket / q_dim)", 2)
    if s is None:
        return IdentityCodec(wire=wire)
    return QSGDCodec(wire=wire, s_levels=int(s), backend=backend)
