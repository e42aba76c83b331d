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

Messages are the rows of the last dimension: a (rows, n) input is ``rows``
messages with one norm each (the N worker uploads of a round), a 1-D input
one message.  Randomness comes in as a uniform(0, 1) tensor shaped like the
input, so both backends are deterministic functions of their inputs.  No
padding to a tile grid: the kernels mask their own ragged edge.
"""
from __future__ import annotations

import torch

from ..kernels import qsgd as K
from ..kernels.qsgd import level_dtype

__all__ = ["level_dtype", "qsgd_levels", "encode", "decode", "encode_cuda",
           "decode_apply_cuda"]


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
