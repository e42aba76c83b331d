"""Transformer building blocks of the LM stack (``repro/models/blocks.py``):
RMSNorm, RoPE, GQA attention and the gated MLP, in PyTorch.

The layout is the JAX package's: activations (B, S, D), q/k/v
(B, S, heads, dh) with head h = kv * G + g, caches
``{"k", "v": (B, C, KV, dh), "pos": (B, C) int32 (-1 = empty),
"idx": (B,) int32}``.  Prefill attention is plain PyTorch (einsum, mask,
softmax), query-chunked as the reference is; single-token decode attention
is flash decode (K6, :mod:`repro_torch.kernels.flash_decode`).  Decode
updates its cache in place (the JAX function returns a new one) and returns
it.  Under M-RoPE (qwen2-vl) positions are ``positions3`` (3, B, S), the
(t, h, w) streams; the causal mask and the cache's positions take stream 0,
the temporal order, as the reference does.  ``causal=False`` (whisper's
encoder and cross-attention) attends over every key, less those
``k_valid`` masks.  The projections go through :func:`matmul`, which
promotes mixed operand types as ``jnp.matmul`` does (whisper's f32 frames
and encoder states meet bf16 weights under the training runtime's bf16
view); with equal types it is ``a @ b``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels.flash_decode import flash_decode

__all__ = ["Q_CHUNK", "dense_init", "rmsnorm", "rope_freqs", "apply_rope",
           "attn_init", "attn_apply", "attn_decode", "make_cache",
           "mlp_init", "mlp_apply", "apply_mrope", "layernorm", "matmul"]

Q_CHUNK = 1024  # query chunk for attention score tiles


# ---------------------------------------------------------------------------
# init helpers: the JAX package's distributions, drawn from a torch.Generator
# on its device; ``lead`` stacks that many layers on a leading axis
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, lead: tuple = ()) -> torch.Tensor:
    w = torch.randn(*lead, d_in, d_out, generator=generator,
                    device=generator.device)
    return w.mul_(1.0 / np.sqrt(d_in)).to(dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps: float = 1e-5):
    """LayerNorm: f32 statistics (the population variance), the affine
    transform in f32, then x's type.  No model calls it (whisper uses
    rmsnorm, as in the JAX package, whose ``layernorm`` has no caller
    either): kept as that package's counterpart, to go with it."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return (((xf - mu) * torch.rsqrt(var + eps)) * w + b).to(x.dtype)


def matmul(a, b):
    """``a @ b`` with both operands cast to their promoted type where the
    types differ, as ``jnp.matmul`` promotes them (``torch.matmul`` refuses
    mixed types): an f32 operand is never rounded down."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """RoPE's inverse frequencies theta^(-2i/d_head), i < d_head/2, f32, on
    ``device`` (the card unless the caller asks for the CPU; with no card
    it raises)."""
    half = d_head // 2
    device = resolve_device("cuda" if device is None else device)
    return 1.0 / theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=device) / half)


def _rope_cos_sin(positions, d_head: int, theta: float):
    """cos, sin of (B, S, 1, dh/2) for positions (B, S)."""
    inv = rope_freqs(d_head, theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, dh); positions: (B, S) int."""
    return _rotate(x, *_rope_cos_sin(positions, x.shape[-1], theta))


def _mrope_cos_sin(positions3, d_head: int, theta: float, sections):
    """cos, sin of (B, S, 1, dh/2) for positions3 (3, B, S): frequency band
    i takes its position from stream ``repeat(arange(3), sections)[i]``."""
    if sum(sections) != d_head // 2:
        raise ValueError(f"mrope_sections {tuple(sections)} must sum to "
                         f"d_head / 2 = {d_head // 2}")
    inv = rope_freqs(d_head, theta, positions3.device)
    ends = np.cumsum((0, *sections))
    ang = torch.cat([positions3[i][..., None].float()
                     * inv[ends[i]:ends[i + 1]] for i in range(3)],
                    dim=-1)                                  # (B,S,dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_mrope(x, positions3, theta: float, sections):
    """Multimodal RoPE (qwen2-vl): x (B, S, H, dh); positions3 (3, B, S) =
    the (t, h, w) streams; the dh/2 frequency bands are split into
    ``sections`` consuming different position streams."""
    return _rotate(x, *_mrope_cos_sin(positions3, x.shape[-1], theta,
                                      sections))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attn_init(generator, cfg: ArchConfig, dtype=torch.float32,
              lead: tuple = ()):
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    dev = generator.device
    p = {
        "wq": dense_init(generator, D, H * dh, dtype, lead),
        "wk": dense_init(generator, D, KV * dh, dtype, lead),
        "wv": dense_init(generator, D, KV * dh, dtype, lead),
        "wo": dense_init(generator, H * dh, D, dtype, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(*lead, dh, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(*lead, dh, dtype=dtype, device=dev)
    return p


def _qkv(p, x, cfg: ArchConfig, positions):
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = matmul(x, p["wq"]).reshape(B, S, H, dh)
    k = matmul(x, p["wk"]).reshape(B, S, KV, dh)
    v = matmul(x, p["wv"]).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    # one cos/sin for q and k (the reference computes the same twice)
    if cfg.mrope:
        cos, sin = _mrope_cos_sin(positions, dh, cfg.rope_theta,
                                  cfg.mrope_sections)
    else:
        cos, sin = _rope_cos_sin(positions, dh, cfg.rope_theta)
    return _rotate(q, cos, sin), _rotate(k, cos, sin), v


def _sdpa_chunk(q, k, v, q_pos, k_pos, window: Optional[int],
                causal: bool = True, k_valid=None):
    """Attention of q: (B,Q,KV,G,dh) over k/v: (B,S,KV,dh) ->
    (B,Q,KV,G,dh): causal by the position vectors (no S×S global mask),
    or over every key (the positions unused); ``k_valid`` (B, S) masks
    keys out in both."""
    dh = q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    scores = scores / math.sqrt(dh)
    m = None
    if causal:
        m = k_pos[:, None, :] <= q_pos[:, :, None]          # (B,Q,S)
        if window is not None:
            m &= k_pos[:, None, :] > q_pos[:, :, None] - window
    if k_valid is not None:
        m = k_valid[:, None, :] if m is None else m & k_valid[:, None, :]
    if m is not None:
        scores = scores.masked_fill(~m[:, None, None, :, :], -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)


def attn_apply(p, x, cfg: ArchConfig, positions, *, window=None,
               causal: bool = True):
    """Full-sequence attention (train / prefill), query-chunked: causal,
    or over every position with ``causal=False``.

    Returns (y, (k, v)): prefill builds its caches from k and v."""
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    G = H // KV
    q, k, v = _qkv(p, x, cfg, positions)
    q = q.reshape(B, S, KV, G, dh)
    tok_pos = positions[0] if cfg.mrope else positions      # (B,S)
    n_chunks = max(1, S // Q_CHUNK)
    if S % Q_CHUNK == 0 and n_chunks > 1:
        outs = [_sdpa_chunk(q[:, i * Q_CHUNK:(i + 1) * Q_CHUNK], k, v,
                            tok_pos[:, i * Q_CHUNK:(i + 1) * Q_CHUNK],
                            tok_pos, window, causal)
                for i in range(n_chunks)]
        out = torch.cat(outs, dim=1).reshape(B, S, H * dh)
    else:
        out = _sdpa_chunk(q, k, v, tok_pos, tok_pos, window, causal)
        out = out.reshape(B, S, H * dh)
    return matmul(out, p["wo"]), (k, v)


def attn_decode(p, x, cfg: ArchConfig, positions, cache, *, window=None):
    """Single-token decode against a dense or ring-buffer KV cache, through
    flash decode (K6).

    cache: {"k": (B, C, KV, dh), "v": ..., "pos": (B, C) int32 positions of
    cached entries (-1 = empty), "idx": (B,) per-row write cursors}, updated
    in place: the new k/v/pos go to slot ``idx % C`` (for a sliding-window
    cache C == window and writes wrap around) and ``idx`` advances."""
    B, S, D = x.shape
    if S != 1:
        raise ValueError(f"attn_decode takes one token a row, got S={S}")
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q, k, v = _qkv(p, x, cfg, positions)
    C = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    slot = cache["idx"] % C                                   # (B,)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    tok_pos = positions[0] if cfg.mrope else positions      # (B,1)
    cache["pos"][rows, slot] = tok_pos[:, 0].to(torch.int32)
    cpos = cache["pos"]
    q_pos = tok_pos[:, :1]
    valid = (cpos >= 0) & (cpos <= q_pos)                     # (B, C)
    if window is not None:
        valid &= cpos > q_pos - window
    out = flash_decode(q.reshape(B, KV, H // KV, dh), cache["k"],
                       cache["v"], valid)
    cache["idx"] += 1
    return matmul(out.reshape(B, 1, H * dh), p["wo"]), cache


def make_cache(cfg: ArchConfig, batch: int, length: int,
               dtype=torch.bfloat16, device="cuda", lead: tuple = ()):
    """An empty cache of ``length`` positions on ``device`` (the card
    unless the caller asks for the CPU; with no card it raises)."""
    device = resolve_device(device)
    KV = cfg.n_kv
    return {
        "k": torch.zeros(*lead, batch, length, KV, cfg.d_head, dtype=dtype,
                         device=device),
        "v": torch.zeros(*lead, batch, length, KV, cfg.d_head, dtype=dtype,
                         device=device),
        "pos": torch.full((*lead, batch, length), -1, dtype=torch.int32,
                          device=device),
        "idx": torch.zeros(*lead, batch, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(generator, cfg: ArchConfig, dtype=torch.float32,
             lead: tuple = ()):
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(generator, D, Fd, dtype, lead),
        "w_up": dense_init(generator, D, Fd, dtype, lead),
        "w_down": dense_init(generator, Fd, D, dtype, lead),
    }


def mlp_apply(p, x):
    h = F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    return matmul(h, p["w_down"])
