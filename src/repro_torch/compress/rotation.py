"""Randomized-Hadamard rotation preconditioner (GQFedWAvg's quantizer).

Pre-rotating with ``R = (1/sqrt(d)) H_d D_sigma`` (``H_d`` the
Walsh-Hadamard matrix, ``D_sigma`` random signs) spreads a message's energy
evenly across its coordinates before quantization and is undone exactly
after dequantization; ``R`` is orthonormal, so norms are preserved.  Inputs
are zero-padded to ``next_pow2(n)``: the padded message is what travels.

Messages are the rows of the last dimension, so the N worker uploads of a
round rotate as one (N, d) tensor.  The arithmetic is the JAX package's
``compress/rotation.py`` op for op — sign multiply (exact), butterflies in
the stage order h = 1, 2, 4, ... with (a + b, a - b) on the pairs
(j*2h + t, j*2h + h + t), then the scale ``float32(d ** -0.5)`` — so
``rotate`` and ``unrotate`` are bitwise equal to the reference's.

The sign vector is the murmur3 finalizer of ``idx * 0x9E3779B9 + seed`` in
uint32 arithmetic with wraparound.  PyTorch's CPU build does not multiply
uint32, so :func:`_mix32` computes in int64 and keeps the low 32 bits after
every multiply and add; each multiply is split in 16-bit halves so that no
int64 product overflows.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device

__all__ = ["next_pow2", "rademacher", "fwht", "rotate", "unrotate"]

_MASK32 = 0xFFFFFFFF


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def _mulmod32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for int64 z in [0, 2^32) and a uint32 constant c,
    with every intermediate below 2^49."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(z: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer on int64 holding uint32 values."""
    z = _mulmod32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mulmod32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


@functools.lru_cache(maxsize=32)
def _signs(n: int, seed: int, device: torch.device) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    z = _mix32((_mulmod32(idx, 0x9E3779B9) + (seed & _MASK32)) & _MASK32)
    one = torch.ones((), dtype=torch.float32, device=device)
    return torch.where((z & 1) == 0, one, -one)


def rademacher(n: int, seed: int, device=None) -> torch.Tensor:
    """Deterministic +-1 f32 signs of length n from a 32-bit seed, on
    ``device`` (the card unless the caller asks for the CPU; with no card
    it raises)."""
    return _signs(int(n), int(seed) & _MASK32,
                  resolve_device("cuda" if device is None else device))


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform along the last dimension, whose
    length is a power of two."""
    lead, d = x.shape[:-1], x.shape[-1]
    h = 1
    while h < d:
        x = x.reshape(*lead, d // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, d)
        h *= 2
    return x


def _scale(d: int) -> float:
    """``float32(d ** -0.5)`` as the Python float that holds it exactly."""
    return float(np.float32(d ** -0.5))


def rotate(y: torch.Tensor, seed: int) -> torch.Tensor:
    """R y per message: pad to the next power of two, sign-flip, orthonormal
    WHT.  (..., n) -> (..., next_pow2(n)) f32."""
    flat = y.to(torch.float32)
    n = flat.shape[-1]
    d = next_pow2(n)
    if d != n:
        flat = torch.nn.functional.pad(flat, (0, d - n))
    return fwht(flat * rademacher(d, seed, flat.device)) * _scale(d)


def unrotate(v: torch.Tensor, seed: int, n: int) -> torch.Tensor:
    """R^T v: the exact inverse of :func:`rotate`, cut back to length n.
    (..., d) -> (..., n) f32."""
    d = v.shape[-1]
    out = fwht(v.to(torch.float32)) * _scale(d)
    return (out * rademacher(d, seed, v.device))[..., :n]
