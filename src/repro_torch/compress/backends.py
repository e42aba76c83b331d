"""The two execution backends of the codec: the reference math and the
CUDA kernels.

    xi_i = floor(s * |y_i| / ||y||) + Bernoulli(frac)          (Assumption 1)

``qsgd_levels`` / ``encode`` / ``decode`` are the reference ("torch")
backend, in the same float ops as the JAX package's ``encode_jnp`` /
``decode_jnp``.  ``encode_cuda`` (K1 then K2) and ``decode_apply_cuda`` (K3)
are the kernel ("cuda") backend, :mod:`repro_torch.kernels.qsgd`; on a CPU
tensor they run the kernels' plain versions.  The kernels compute the
scale as ``|y| * (s / ||y||)`` (the TPU kernel's order), the reference as
``(s * |y|) / ||y||``: the two agree except where the noise falls within
an ulp of the fractional part.

The one-pass payload encodes of the "int4" wire are ``encode_fused`` (K4),
``encode_rotated_fused`` (K5, or rotate then K4 above 2^15 coordinates) and
the reference backend's ``encode_fused_torch``.

Messages are the rows of the last dimension: a (rows, n) input is ``rows``
messages with one norm each (the N worker uploads of a round), a 1-D input
one message.  Randomness comes in as a uniform(0, 1) tensor shaped like the
input, so both backends are deterministic functions of their inputs.  No
padding to a tile grid: the kernels mask their own ragged edge.

Per-bucket norms (QSGD bucketing, ``bucket=q``): each message is cut into
buckets of q coordinates, the last zero-padded (zero y, zero u), each
normalized by its own L2 norm, so a (..., n) input gives (...,
ceil(n/q)) norms and levels shaped like y.  ``encode_bucketed`` /
``decode_bucketed`` are the reference backend; the kernel backend runs K1
and K2 on the bucket rows (``encode_bucketed_cuda``), K3b for the server's
apply (``decode_apply_bucketed_cuda``) and K4 for the int4 payload
(``encode_fused_bucketed``).  A bucket of at least the message's length is
one bucket, routed as the whole-message path (norms (..., 1)), so
``bucket >= n`` gives ``bucket=None``'s levels bit for bit.

``encode_tensor`` / ``decode_tensor`` are the functional entry points
(s = None passes the tensor through; the int8 container carries s <=
127).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import fused_encode as FE
from ..kernels import qsgd as K
from ..kernels.fused_encode import FUSED_ROTATE_MAX_DIM
from ..kernels.qsgd import level_dtype
from . import rotation as R
from . import wire as W

__all__ = ["level_dtype", "qsgd_levels", "encode", "decode", "encode_cuda",
           "decode_apply_cuda", "encode_fused", "encode_fused_torch",
           "encode_rotated_fused", "FUSED_ROTATE_MAX_DIM", "n_buckets",
           "to_buckets", "encode_bucketed", "decode_bucketed",
           "encode_bucketed_cuda", "decode_apply_bucketed_cuda",
           "encode_fused_bucketed", "encode_tensor", "decode_tensor"]


# ---------------------------------------------------------------------------
# reference backend
# ---------------------------------------------------------------------------
def qsgd_levels(y: torch.Tensor, u: torch.Tensor, s,
                norm: torch.Tensor) -> torch.Tensor:
    """Signed stochastic levels sign(y) * xi as f32; ``norm`` broadcasts
    against y (one per message, with a trailing axis of 1)."""
    yf = y.to(torch.float32)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    scaled = float(s) * torch.abs(yf) / safe
    base = torch.floor(scaled)
    xi = base + (u < (scaled - base)).to(torch.float32)
    return torch.sign(yf) * xi


def encode(y: torch.Tensor, s, u: torch.Tensor):
    """-> (levels f32 shaped like y, norm per message)."""
    yf = y.to(torch.float32)
    norm = torch.sqrt(torch.sum(yf * yf, dim=-1))
    return qsgd_levels(y, u, s, norm[..., None]), norm


def decode(levels: torch.Tensor, norm: torch.Tensor, s,
           dtype=torch.float32) -> torch.Tensor:
    """Q(y; s) from (levels, norm): levels * (norm / s) per message."""
    scale = norm / torch.full_like(norm, float(s))
    return (levels.to(torch.float32) * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# kernel backend
# ---------------------------------------------------------------------------
def encode_cuda(y: torch.Tensor, s: int, u: torch.Tensor):
    """K1 (norm, inv) then K2 (levels): -> (levels in ``level_dtype(s)``
    shaped like y, norm per message).  Nothing waits on the host."""
    y2 = y.to(torch.float32).reshape(-1, y.shape[-1]).contiguous()
    u2 = u.to(torch.float32).reshape(y2.shape).contiguous()
    _, norm, inv = K.qsgd_sumsq(y2, s)
    lvl = K.qsgd_quantize(y2, u2, inv, s)
    return lvl.reshape(y.shape), norm.reshape(y.shape[:-1])


def decode_apply_cuda(x: torch.Tensor, levels: torch.Tensor,
                      norm: torch.Tensor, s: int, gamma) -> torch.Tensor:
    """K3: x + gamma * decode(levels, norm) for one flat f32 message,
    out of place."""
    return K.qsgd_dequant_apply(x, levels, norm, s, gamma)


# ---------------------------------------------------------------------------
# one-pass fused encode (the payload pipeline's kernel entry points)
# ---------------------------------------------------------------------------
def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.to(torch.float32).reshape(-1, n).contiguous()


def encode_fused(y: torch.Tensor, s: int, u: torch.Tensor, *,
                 pack: bool = False):
    """K4: norm + quantize (+ int4 pack) of each message in one pass, the
    same bytes as ``encode_cuda`` followed by ``wire.pack_int4`` without
    the int8 levels in device memory.

    -> ``(payload, norm)``: packed bytes (..., ceil(n/2)) when ``pack``,
    else int8 levels shaped like ``y``; one norm per message."""
    FE.check_fused_s(int(s), pack)
    n = y.shape[-1]
    out, norm = FE.fused_encode(_rows(y, n), _rows(u, n), s, pack)
    return (out.reshape(*y.shape[:-1], out.shape[-1]),
            norm.reshape(y.shape[:-1]))


def encode_fused_torch(y: torch.Tensor, s, u: torch.Tensor, *,
                       pack: bool = False):
    """The reference backend's payload pipeline: ``encode`` then the nibble
    pack; the same payload contract as :func:`encode_fused` (the codec
    layer validates s)."""
    lvl, norm = encode(y, s, u)
    lvl = lvl.to(torch.int8)
    return (W.pack_int4(lvl) if pack else lvl), norm


def encode_rotated_fused(y: torch.Tensor, s: int, u: torch.Tensor, seed: int,
                         *, pack: bool = False):
    """One-pass rotated encode: K5 for messages whose power-of-two padded
    length d is at most ``FUSED_ROTATE_MAX_DIM``; above that ``rotate``,
    then K4.  ``u`` has the padded length d per message.

    -> ``(payload, norm)`` of the *padded* message: (..., d/2) packed bytes
    or (..., d) int8 levels — the padded message is what travels."""
    FE.check_fused_s(int(s), pack)
    n = y.shape[-1]
    d = R.next_pow2(n)
    if d > FUSED_ROTATE_MAX_DIM:
        return encode_fused(R.rotate(y, seed), s, u, pack=pack)
    ypad = torch.nn.functional.pad(_rows(y, n), (0, d - n))
    out, norm = FE.fused_rotate_encode(ypad, _rows(u, d), s, seed, pack)
    return (out.reshape(*y.shape[:-1], out.shape[-1]),
            norm.reshape(y.shape[:-1]))


# ---------------------------------------------------------------------------
# per-bucket norms (QSGD bucketing)
# ---------------------------------------------------------------------------
def n_buckets(n: int, bucket: int) -> int:
    """Buckets of ``bucket`` coordinates in a message of n (the last one
    zero-padded)."""
    if bucket < 1:
        raise ValueError(f"bucket must be positive, got {bucket}")
    return -(-n // bucket)


def to_buckets(t: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad each message (last axis) to whole buckets -> (...,
    n_buckets, bucket) f32."""
    n = t.shape[-1]
    pad = n_buckets(n, bucket) * bucket - n
    t = torch.nn.functional.pad(t.to(torch.float32), (0, pad))
    return t.reshape(*t.shape[:-1], -1, bucket)


def _from_buckets(t: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n_buckets, bucket) -> (..., n): the padding cut off."""
    return t.reshape(*t.shape[:-2], -1)[..., :n]


def encode_bucketed(y: torch.Tensor, s, u: torch.Tensor, bucket: int):
    """Reference per-bucket encode: -> (levels f32 shaped like y, norms
    (..., n_buckets))."""
    n = y.shape[-1]
    if n_buckets(n, bucket) == 1:
        lvl, norm = encode(y, s, u)
        return lvl, norm[..., None]
    lvl, norms = encode(to_buckets(y, bucket), s, to_buckets(u, bucket))
    return _from_buckets(lvl, n), norms


def decode_bucketed(levels: torch.Tensor, norms: torch.Tensor, s,
                    dtype=torch.float32, bucket: int = 1) -> torch.Tensor:
    """Q(y; s) from levels (..., n) and norms (..., n_buckets)."""
    n = levels.shape[-1]
    if n_buckets(n, bucket) == 1:
        return decode(levels, norms[..., 0], s, dtype)
    return _from_buckets(decode(to_buckets(levels, bucket), norms, s, dtype),
                         n)


def encode_bucketed_cuda(y: torch.Tensor, s: int, u: torch.Tensor,
                         bucket: int):
    """K1 then K2 over the (rows * n_buckets, bucket) bucket rows: ->
    (levels in ``level_dtype(s)`` shaped like y, norms (...,
    n_buckets))."""
    n = y.shape[-1]
    if n_buckets(n, bucket) == 1:
        lvl, norm = encode_cuda(y, s, u)
        return lvl, norm[..., None]
    yb, ub = to_buckets(y, bucket), to_buckets(u, bucket)
    lvl, norm = encode_cuda(yb, s, ub)
    return _from_buckets(lvl, n), norm


def decode_apply_bucketed_cuda(x: torch.Tensor, levels: torch.Tensor,
                               norms: torch.Tensor, s: int, gamma,
                               bucket: int) -> torch.Tensor:
    """K3b (K3 for one bucket): x + gamma * decode_bucketed(levels, norms)
    for one flat f32 message, out of place."""
    if norms.numel() == 1:
        return K.qsgd_dequant_apply(x, levels, norms.reshape(1), s, gamma)
    return K.qsgd_dequant_apply_bucketed(x, levels.contiguous(),
                                         norms.reshape(-1), s, gamma, bucket)


def encode_fused_bucketed(y: torch.Tensor, s: int, u: torch.Tensor,
                          bucket: int, *, pack: bool = False):
    """K4 over the bucket rows: -> (payload, norms (..., n_buckets)); the
    payload is the flat message's (..., ceil(n/2)) packed bytes (or its int8
    levels).  For an even bucket the rows' packs laid end to end are the
    flat pack; for an odd one a byte straddles two buckets, so K4 gives the
    int8 levels and the flat levels are packed."""
    FE.check_fused_s(int(s), pack)
    n = y.shape[-1]
    if n_buckets(n, bucket) == 1:
        out, norm = encode_fused(y, s, u, pack=pack)
        return out, norm[..., None]
    yb, ub = to_buckets(y, bucket), to_buckets(u, bucket)
    lead, nb = yb.shape[:-2], yb.shape[-2]
    whole = pack and bucket % 2 == 0
    out, norm = FE.fused_encode(yb.reshape(-1, bucket),
                                ub.reshape(-1, bucket), s, whole)
    out = out.reshape(*lead, -1)
    norm = norm.reshape(*lead, nb)
    if whole:
        return out[..., :(n + 1) // 2], norm
    out = out[..., :n]
    return (W.pack_int4(out) if pack else out), norm


# ---------------------------------------------------------------------------
# functional per-tensor entry points (None = identity)
# ---------------------------------------------------------------------------
def encode_tensor(y: torch.Tensor, s: Optional[int], u: torch.Tensor,
                  backend: str = "torch", bucket: Optional[int] = None):
    """-> (levels int8 shaped like y, norm per message); passthrough
    ``(y, 1.0)`` for s = None.

    The norm is one per message, or (..., n_buckets) when ``bucket`` is
    set (the bucketing ``QSGDCodec(bucket=...)`` implements and
    ``EdgeSystem(q_dim=...)`` prices).  The int8 container bounds s at 127,
    as the runtime's wire does; a ``QSGDCodec`` carries wider quantizers.
    ``backend`` "cuda" runs the kernels (plain versions on a CPU tensor)."""
    if s is None:
        return y, torch.ones((), dtype=torch.float32, device=y.device)
    if s > 127:
        raise ValueError(f"encode_tensor's int8 container carries s <= 127, "
                         f"got {s}; use QSGDCodec for wider quantizers")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if bucket is not None:
        enc = encode_bucketed_cuda if backend == "cuda" else encode_bucketed
        lvl, norm = enc(y, s, u, bucket)
    else:
        lvl, norm = (encode_cuda if backend == "cuda" else encode)(y, s, u)
    return lvl.to(torch.int8), norm


def decode_tensor(levels: torch.Tensor, norm: torch.Tensor, s: Optional[int],
                  dtype=torch.float32,
                  bucket: Optional[int] = None) -> torch.Tensor:
    if s is None:
        return levels.to(dtype)
    if bucket is not None:
        return decode_bucketed(levels, norm, s, dtype, bucket)
    return decode(levels, norm, s, dtype)
