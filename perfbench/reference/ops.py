"""The layers both reference models use, in plain PyTorch.

Precision follows the configurations' ``precision`` block: the products
take their operands in the compute type (bf16 for the benchmark's cells);
norms' statistics, RoPE, attention scores and softmax, and the loss are
f32, the result of each cast back to the compute type where it feeds a
product.  TF32 stays off (the references set it off before they run)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def rmsnorm(x, w, eps: float):
    """x / rms(x) in f32, cast back to x's type, times the weight."""
    xf = x.to(F32)
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * w


def rope(x, theta: float):
    """Rotate-half RoPE over x (B, S, heads, dh) at positions 0..S-1, in
    f32: frequency i is theta^(-i / (dh/2))."""
    S, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q, k, v, causal: bool):
    """Softmax attention of q (B, S, H, dh) over k, v (B, T, KV, dh), query
    head h reading key head h // (H / KV) -> (B, S, H * dh)."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.to(F32), k.to(F32)) / math.sqrt(dh)
    if causal:
        T = k.shape[1]
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)
    return o.reshape(B, S, H * dh)


def gated_mlp(p, x):
    """SiLU(x Wg) * (x Wu), then W_down."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def mean_ce(h, head, labels):
    """Mean cross entropy of the logits h @ head (in h's type, then f32)
    against labels."""
    logits = (h @ head).to(F32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
