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
"""
from __future__ import annotations

import torch

from ..kernels import fused_encode as FE
from ..kernels import qsgd as K
from ..kernels.fused_encode import FUSED_ROTATE_MAX_DIM
from ..kernels.qsgd import level_dtype
from . import rotation as R
from . import wire as W

__all__ = ["level_dtype", "qsgd_levels", "encode", "decode", "encode_cuda",
           "decode_apply_cuda", "encode_fused", "encode_fused_torch",
           "encode_rotated_fused", "FUSED_ROTATE_MAX_DIM"]


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
