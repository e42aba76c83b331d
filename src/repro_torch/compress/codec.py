"""Codec objects: the paper's abstract quantizer (q_s, M_s) made concrete.

A codec bundles the four things every layer of the system needs from the
quantizer ``Q(·; s)``:

  encode(tensor, noise) -> (levels, norm)   stochastic quantization
  decode(levels, norm)  -> tensor           dequantization
  wire_bits(dim)        -> M_s              bits per message (cost layer)
  variance_bound(dim)   -> q_s              Assumption-1 variance constant

Instances:
  :class:`QSGDCodec`     — the paper's Assumption-1 quantizer, one norm per
                           message or, with ``bucket``, one per bucket of
                           its coordinates (matching the cost layer's
                           ``q_dim``); backend "torch" (reference math) or
                           "cuda" (the hand-written kernels; plain versions
                           on CPU tensors).
  :class:`RotatedQSGDCodec` — QSGD on the randomized-Hadamard rotated,
                           power-of-two padded message (GQFedWAvg's
                           quantizer).
  :class:`IdentityCodec` — s = ∞: exact passthrough, q_s = 0, recovering
                           PM-SGD / FedAvg / PR-SGD as special cases.
  :class:`ErrorFeedbackCodec` — memory-compensated quantization around any
                           of the above, its residual threaded through by
                           the caller.

Every codec also has the one-pass payload pipeline ``encode_payload`` /
``decode_payload``: straight from the message to the bytes of its wire
(the fused kernels K4/K5 for "int4" on the "cuda" backend, the Elias-omega
coder of :mod:`repro_torch.compress.elias` for "elias").

``make_codec`` is the single constructor the rest of the package uses.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from . import backends as B
from . import elias as E
from . import rotation as R
from . import wire as W

__all__ = ["Codec", "QSGDCodec", "IdentityCodec", "RotatedQSGDCodec",
           "ErrorFeedbackCodec", "CODEC_BACKENDS", "CODEC_KINDS",
           "make_codec", "variance_bound", "bits_per_message", "q_pair"]

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
          wire "elias" — Elias-omega coded words, (..., word_capacity(m))
                         int32, one stream a message; s <= 127 (the coder
                         reads int8 levels);
          otherwise    — the levels themselves in their wire container.

        ``nbits`` is the payload's size on the wire (container bits,
        excluding the 32-bit norm words): an int, or for "elias" the
        realized streams' total as an int64 tensor on the payload's device
        (nothing waits on the host).  ``decode_payload`` is the exact
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
      bucket: per-bucket-norm quantization — each message is split into
        buckets of this many coordinates, each normalized by its own L2
        norm (Assumption 1 then holds per bucket with D = bucket); norms
        come out (..., n_buckets).  ``None`` = one norm per message.
      backend: "torch" reference math or "cuda" kernels; levels are int8
        for s <= 127 and int32 above, on both.
    """

    s_levels: int = 1
    bucket: Optional[int] = None
    backend: str = "torch"

    def __post_init__(self):
        if self.s_levels <= 0:
            raise ValueError(f"s must be positive, got {self.s_levels}")
        if self.bucket is not None and self.bucket < 1:
            raise ValueError(f"bucket must be positive, got {self.bucket}")
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
        """-> (levels shaped like y, norm per message — or (...,
        n_buckets) norms with ``bucket``)."""
        if self.bucket is not None:
            if self.backend == "cuda":
                return B.encode_bucketed_cuda(y, self.s_levels, u,
                                              self.bucket)
            lvl, norms = B.encode_bucketed(y, self.s_levels, u, self.bucket)
            return lvl.to(self.level_dtype), norms
        if self.backend == "cuda":
            return B.encode_cuda(y, self.s_levels, u)
        lvl, norm = B.encode(y, self.s_levels, u)
        return lvl.to(self.level_dtype), norm

    def decode(self, levels: torch.Tensor, norm: torch.Tensor,
               dtype=torch.float32):
        if self.bucket is not None:
            return B.decode_bucketed(levels, norm, self.s_levels, dtype,
                                     self.bucket)
        return B.decode(levels, norm, self.s_levels, dtype)

    def decode_apply(self, x: torch.Tensor, levels: torch.Tensor,
                     norm: torch.Tensor, gamma) -> torch.Tensor:
        """x + gamma * decode(levels) — the fused K3 (K3b with buckets) on
        the cuda backend."""
        if self.backend == "cuda":
            if self.bucket is not None:
                return B.decode_apply_bucketed_cuda(x, levels, norm,
                                                    self.s_levels, gamma,
                                                    self.bucket)
            return B.decode_apply_cuda(x, levels, norm, self.s_levels, gamma)
        upd = gamma * self.decode(levels, norm)
        return (x.to(torch.float32) + upd).to(x.dtype)

    # -- the one-pass encode pipeline ------------------------------------
    def _payload(self, lvl: torch.Tensor, norm: torch.Tensor):
        """(payload, norm, nbits) of levels on a wire that carries levels:
        the Elias-omega streams of "elias", else the levels in their
        container."""
        if self.wire != "elias":
            return lvl, norm, int(W.level_bits(self.s_levels, self.wire)
                                  * lvl.numel())
        if self.s_levels > E.MAX_RUNTIME_S:
            raise ValueError(f"the elias coder reads levels from an int8 "
                             f"container (s <= {E.MAX_RUNTIME_S}), got "
                             f"s={self.s_levels}")
        words, nbits = E.encode_levels(lvl.to(torch.int8))
        return words, norm, nbits.to(torch.int64).sum()

    def encode_payload(self, y: torch.Tensor, u: torch.Tensor):
        if self.wire != "int4":
            return self._payload(*self.encode(y, u))
        if self.backend != "cuda":       # the reference: encode, then pack
            lvl, norm = self.encode(y, u)
            packed = W.pack_int4(lvl)
        elif self.bucket is not None:
            packed, norm = B.encode_fused_bucketed(y, self.s_levels, u,
                                                   self.bucket, pack=True)
        else:
            packed, norm = B.encode_fused(y, self.s_levels, u, pack=True)
        return packed, norm, 8 * packed.numel()

    def _payload_levels(self, payload: torch.Tensor, n: int):
        if self.wire == "int4":
            return W.unpack_int4(payload, n)
        if self.wire == "elias":
            return E.decode_levels(payload, n)
        return payload[..., :n]

    def decode_payload(self, payload: torch.Tensor, norm: torch.Tensor,
                       n: int, dtype=torch.float32):
        return self.decode(self._payload_levels(payload, n), norm, dtype)

    # -- cost-layer views ------------------------------------------------
    def wire_bits(self, dim: int) -> float:
        return W.wire_bits(self.s_levels, dim, wire=self.wire,
                           bucket=self.bucket)

    def variance_bound(self, dim: int) -> float:
        eff = dim if self.bucket is None else min(self.bucket, dim)
        return variance_bound(self.s_levels, eff)


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

    def __post_init__(self):
        super().__post_init__()
        if self.bucket is not None:
            raise ValueError("rotation preconditioning and per-bucket norms "
                             "are mutually exclusive (the rotation already "
                             "isotropizes the message)")

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


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCodec:
    """Memory-compensated (EF-)quantization around any inner codec.

    Encodes the *error-compensated* message ``y + e`` and carries the new
    residual ``e' = (y + e) - decode(encode(y + e))`` as explicit state —
    codecs stay frozen/stateless, so the caller threads ``state`` through
    (``init_state`` → ``encode``/``quantize_dequantize`` → next round).  The
    telescoping identity ``sum_t decode_t = sum_t y_t + e_0 - e_T`` makes
    the *cumulative* applied update track the true sum to within one
    residual.  ``state`` is the flat residual of the whole input.

    EF-compensated quantization is **biased** per message: Assumption 1's
    unbiasedness fails, so Theorem 1 (and every family's convergence
    block) does not cover it, and ``variance_bound`` raises to keep the
    optimizer from pricing ``q_s`` for it.  It is for the runtime, not for
    ``Scenario.optimize``.
    """

    inner: Codec

    @property
    def s(self) -> Optional[int]:
        return self.inner.s

    @property
    def wire(self) -> str:
        return self.inner.wire

    def init_state(self, dim: int, device="cuda") -> torch.Tensor:
        """The zero residual memory: an f32 vector of the message
        dimension on ``device`` (the card unless the caller asks for the
        CPU)."""
        from .. import resolve_device
        return torch.zeros(int(dim), dtype=torch.float32,
                           device=resolve_device(device))

    def encode(self, y: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
        """-> (levels, norm, new_state); ``state`` is the flat residual."""
        comp = y.to(torch.float32) + state.reshape(y.shape)
        lvl, norm = self.inner.encode(comp, u)
        # a rotated inner decodes to the padded message: cut it to comp's
        sent = self.inner.decode(lvl, norm)[..., :comp.shape[-1]]
        return lvl, norm, (comp - sent).reshape(-1)

    def decode(self, levels: torch.Tensor, norm: torch.Tensor,
               dtype=torch.float32):
        return self.inner.decode(levels, norm, dtype)

    def quantize_dequantize(self, y: torch.Tensor, u: torch.Tensor,
                            state: torch.Tensor):
        """-> (value, new_state): the stateful twin of the codec method,
        with the uniform noise ``u`` passed in (of the inner codec's
        ``padded_dim``)."""
        comp = y.to(torch.float32) + state.reshape(y.shape)
        sent = self.inner.quantize_dequantize(comp, u)
        return sent, (comp - sent).reshape(-1)

    def wire_bits(self, dim: int) -> float:
        return self.inner.wire_bits(dim)

    def variance_bound(self, dim: int) -> float:
        raise TypeError(
            "error-feedback quantization is biased: Assumption 1's q_s does "
            "not exist, so no family's convergence block may price it — run "
            "it in the runtime, keep the optimizer on the inner codec")


@functools.lru_cache(maxsize=1024)
def make_codec(s: Optional[int], wire: str = "packed",
               bucket: Optional[int] = None, backend: str = "torch",
               kind: str = "qsgd", seed: int = 0) -> Codec:
    """The one constructor: s=None -> IdentityCodec, else QSGDCodec (with
    per-bucket norms for ``bucket``), or the rotation-preconditioned
    variant for ``kind="rotated"``, whose signs come from ``seed`` (a
    bucket there raises: the two are mutually exclusive).

    Codecs are frozen/stateless, so instances are memoized — the cost layer
    reconstructs them inside the GIA inner loop and must not pay object
    churn there.
    """
    if kind not in CODEC_KINDS:
        raise ValueError(f"unknown codec kind {kind!r}; "
                         f"expected one of {CODEC_KINDS}")
    if s is None:
        return IdentityCodec(wire=wire)
    if kind == "rotated":
        return RotatedQSGDCodec(wire=wire, s_levels=int(s), bucket=bucket,
                                backend=backend, seed=int(seed))
    return QSGDCodec(wire=wire, s_levels=int(s), bucket=bucket,
                     backend=backend)
