"""Mamba2 (SSD, state-space duality) mixer (``repro/models/mamba2.py``): the
chunked parallel form for training and prefill, and the O(1) recurrent
update for decode, in PyTorch.

The "minimal mamba2" formulation with a single B/C group:
  h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t^T      (per head h)
  y_t = C_t . h_t + D_h * x_t
with x projected to (H, P) heads, A a scalar per head, B/C of size
N = ssm_state.  The parallel form is an intra-chunk "attention" term plus
an inter-chunk state carry (a Python loop over chunks where the reference
scans).  A sequence runs in chunks of ``CHUNK`` when it is a multiple of
it, else as one chunk of S, as in the reference.

The reference's three-operand einsums are contracted here as batched
products: the intra-chunk term as (L * CB^T) @ (x dt) over k, so at
zamba2's 80 heads and S = 2047 the (B, Nc, H, Q, Q) f32 matrix (1.3 GB) is
the largest temporary, and nothing is broadcast over the head width P.

Decode updates the state dict ``{"h", "conv"}`` in place (``copy_`` casts
to the cache's type) and returns it.  A prefill that returns the state
needs ``ssm_conv - 1`` tokens at least for the conv tail; a shorter
sequence raises :class:`ValueError` (the reference's slice then yields
fewer rows and its engine replaces the whole cache leaf, ROADMAP.md,
Queue 3).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ArchConfig
from .blocks import dense_init, rmsnorm

__all__ = ["CHUNK", "mamba2_dims", "mamba2_init", "mamba2_apply",
           "mamba2_decode", "make_ssm_state"]

CHUNK = 128


def mamba2_dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(generator, cfg: ArchConfig, dtype=torch.float32,
                lead: tuple = ()):
    D, W = cfg.d_model, cfg.ssm_conv
    di, H, P, N = mamba2_dims(cfg)
    dev = generator.device
    conv_ch = di + 2 * N
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=dev).clamp(1.0, 16.0))
    return {
        # projections for z (gate), x, B, C, dt
        "in_proj": dense_init(generator, D, 2 * di + 2 * N + H, dtype, lead),
        "conv_w": torch.randn(*lead, W, conv_ch, generator=generator,
                              device=dev).div_(math.sqrt(W)).to(dtype),
        "conv_b": torch.zeros(*lead, conv_ch, dtype=dtype, device=dev),
        "A_log": a_log.expand(*lead, H).clone(),
        "D": torch.ones(*lead, H, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(*lead, H, dtype=torch.float32, device=dev),
        "out_norm": torch.ones(*lead, di, dtype=dtype, device=dev),
        "out_proj": dense_init(generator, di, D, dtype, lead),
    }


def _split_proj(p, x, cfg: ArchConfig):
    di, H, P, N = mamba2_dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di:2 * di]
    Bc = zxbcdt[..., 2 * di:2 * di + N]
    Cc = zxbcdt[..., 2 * di + N:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xin, Bc, Cc, dt


def _causal_conv(seq, w, b):
    """Depthwise causal conv: seq (B, S, C), w (W, C)."""
    W, S = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return out + b


def _segsum_exp(dA_cum):
    """L[.., i, j] = exp(dA_cum[.., i] - dA_cum[.., j]) for i >= j else 0.

    dA_cum: (..., Q); returns (..., Q, Q).  The mask comes BEFORE the exp:
    the upper triangle's differences are positive and large, and an
    overflow there would leak NaN through the backward of a where()."""
    Q = dA_cum.shape[-1]
    diff = dA_cum[..., :, None] - dA_cum[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=dA_cum.device).tril()
    return torch.exp(diff.masked_fill(~mask, -1e30))


def mamba2_apply(p, x, cfg: ArchConfig, return_state: bool = False):
    """x: (B, S, D) -> y: (B, S, D); with ``return_state`` -> (y, {"h":
    (B, N, H, P) f32, "conv": the last ssm_conv - 1 pre-activation conv
    inputs (B, ssm_conv - 1, di + 2N)})."""
    Bt, S, D = x.shape
    di, H, P, N = mamba2_dims(cfg)
    W = cfg.ssm_conv
    if return_state and S < W - 1:
        raise ValueError(f"mamba2: a sequence of {S} token(s) is shorter "
                         f"than the conv tail of ssm_conv - 1 = {W - 1}")
    f32 = torch.float32
    z, xin, Bc, Cc, dt = _split_proj(p, x, cfg)
    cin = torch.cat([xin, Bc, Cc], dim=-1)
    conv = F.silu(_causal_conv(cin, p["conv_w"], p["conv_b"]))
    xin, Bc, Cc = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                  # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,)
    xh = xin.reshape(Bt, S, H, P)

    Q = CHUNK if S % CHUNK == 0 else S
    Nc = S // Q
    xq = xh.reshape(Bt, Nc, Q, H, P)
    dtq = dt.reshape(Bt, Nc, Q, H)
    Bq = Bc.reshape(Bt, Nc, Q, N).to(f32)
    Cq = Cc.reshape(Bt, Nc, Q, N).to(f32)
    dA_cum = torch.cumsum(dtq * A, dim=2)                        # (B,Nc,Q,H)
    xdt = (xq * dtq[..., None]).to(f32)                          # (B,Nc,Q,H,P)

    # --- intra-chunk (diagonal blocks): sum_k L[h,q,k] CB[q,k] xdt[k,h,p]
    L = _segsum_exp(dA_cum.movedim(-1, 2))                       # (B,Nc,H,Q,Q)
    att = Cq @ Bq.transpose(-1, -2)                              # (B,Nc,Q,Q)
    M = L * att[:, :, None]
    xk = xdt.permute(0, 1, 3, 2, 4)                              # (B,Nc,H,Q,P)
    y_diag = (M @ xk).permute(0, 1, 3, 2, 4)                     # (B,Nc,Q,H,P)
    del L, M

    # --- inter-chunk state carry -------------------------------------------
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (B,Nc,Q,H)
    xw = (xdt * decay_to_end[..., None]).reshape(Bt, Nc, Q, H * P)
    chunk_states = (Bq.transpose(-1, -2) @ xw).reshape(Bt, Nc, N, H, P)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                 # (B,Nc,H)
    h = torch.zeros(Bt, N, H, P, dtype=f32, device=x.device)
    prev = []
    for c in range(Nc):                     # the state *before* each chunk
        prev.append(h)
        h = h * chunk_decay[:, c, None, :, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (B,Nc,N,H,P)

    decay_from_start = torch.exp(dA_cum)                         # (B,Nc,Q,H)
    y_off = (Cq @ prev_states.reshape(Bt, Nc, N, H * P)).reshape(
        Bt, Nc, Q, H, P) * decay_from_start[..., None]

    y = (y_diag + y_off).reshape(Bt, S, H, P)
    y = y + p["D"][:, None] * xh.to(f32)
    y = y.reshape(Bt, S, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, p["out_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        # conv tail: the last ssm_conv - 1 pre-activation channel inputs
        return out, {"h": h, "conv": cin[:, S - (W - 1):]}
    return out


def make_ssm_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cuda", lead: tuple = ()):
    """An empty state on ``device`` (the card unless the caller asks for
    the CPU; with no card it raises): h in f32, the conv tail in
    ``dtype``."""
    device = resolve_device(device)
    di, H, P, N = mamba2_dims(cfg)
    return {
        "h": torch.zeros(*lead, batch, N, H, P, dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(*lead, batch, cfg.ssm_conv - 1, di + 2 * N,
                            dtype=dtype, device=device),
    }


def mamba2_decode(p, x, cfg: ArchConfig, state):
    """Single-token step.  x: (B, 1, D); ``state`` from
    :func:`make_ssm_state` (or a prefill), updated in place and returned:
    -> (y (B, 1, D), state)."""
    Bt, S, D = x.shape
    if S != 1:
        raise ValueError(f"mamba2_decode takes one token a row, got S={S}")
    di, H, P, N = mamba2_dims(cfg)
    f32 = torch.float32
    z, xin, Bc, Cc, dt = _split_proj(p, x, cfg)
    cin = torch.cat([xin, Bc, Cc], dim=-1)                       # (B,1,C)
    window = torch.cat([state["conv"], cin], dim=1)              # (B,W,C)
    conv = F.silu((window * p["conv_w"]).sum(dim=1) + p["conv_b"])
    xin, Bc, Cc = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"])             # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(Bt, H, P).to(f32)
    dA = torch.exp(dt * A)                                       # (B,H)
    h = state["h"] * dA[:, None, :, None] \
        + Bc.to(f32)[:, :, None, None] * (dt[:, :, None] * xh)[:, None]
    y = torch.einsum("bn,bnhp->bhp", Cc.to(f32), h)
    y = y + p["D"][:, None] * xh
    y = y.reshape(Bt, 1, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, p["out_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return out, state
