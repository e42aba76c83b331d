"""Plain reference of GenQSGD's round (Algorithm 1) over fl workers held in
one process, for the cells' training rounds.

A round from the global model x̂: each worker n takes its K_max local SGD
steps of size γ at the compute type's view of its f32 copy (steps past
its K_n are computed and moved by 0), then uploads its normalized delta
(x_n - x̂)/γ quantized with s_n, leaf by leaf; the server averages the
decoded uploads, quantizes the average with s_0, and every node adds γ
times its decoded value (eqs. (3), (5)).  The int8 wire moves the levels
exactly, so the aggregate is the plain mean of the decoded uploads.

The quantizer is QSGD with stochastic rounding, levels
sign(y) (floor(|y| s/‖y‖) + [u < frac]).  Its uniform draws u are the
counter hash of the flat index under a seed made from a round's key words
and a salt (the leaf's index for the workers, 1000 + index for the
server): a frozen copy of that generator, so the reference draws the
same u from the same key words."""
from __future__ import annotations

import numpy as np
import torch

from .tree import unflatten

F32 = torch.float32
M32 = 0xFFFFFFFF
_CHUNK = 1 << 25


def _mulmod32(z, c: int):
    """(z * c) mod 2^32 for int64 z in [0, 2^32), every product below
    2^49."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix32(z):
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    z = _mulmod32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mulmod32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def _mix32_int(z: int) -> int:
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & M32
    return z ^ (z >> 16)


def uniform(n: int, seed: int, device) -> torch.Tensor:
    """n U(0, 1) f32 draws: the top 24 bits of
    mix32(mix32(i * 0x9E3779B9 + seed) + 0x27D4EB2F) for flat index i."""
    out = torch.empty(n, dtype=F32, device=device)
    for a in range(0, n, _CHUNK):
        z = torch.arange(a, min(n, a + _CHUNK), dtype=torch.int64,
                         device=device)
        z = (_mulmod32(z, 0x9E3779B9) + (seed & M32)) & M32
        z = _mix32((_mix32(z) + 0x27D4EB2F) & M32)
        out[a:a + z.shape[0]] = (z >> 8).to(F32) * (1.0 / (1 << 24))
    return out


def seed_from(words, salt: int) -> int:
    """A leaf's noise seed from a key's uint32 words and a salt."""
    seed = (int(salt) * 0x9E3779B9) & M32
    for w in np.asarray(words).reshape(-1).astype(np.uint32).tolist():
        seed = _mix32_int(seed ^ int(w))
    return seed


def quantize(y, u, s: int):
    """QSGD levels (f32, shaped like y) and the norm of each row of y
    (rows, n)."""
    norm = torch.sqrt(torch.sum(y * y, dim=-1))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    scaled = torch.abs(y) * (torch.full_like(safe, float(s)) / safe)[:, None]
    base = torch.floor(scaled)
    return torch.sign(y) * (base + (u < scaled - base).to(F32)), norm


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def _loss_grad(model, cfg, like, p, batch: dict, rows: int, compute):
    """A step's mean loss and its gradients (f32) at the compute type's
    view of the f32 leaves ``p``, worked out over blocks of ``rows`` rows
    of the batch so that the reference fits beside the program's freed
    state: each block's mean loss and gradients weighted by its share of
    the rows (every row has as many labels)."""
    B = next(iter(batch.values())).shape[0]
    view = [t.detach().to(compute).requires_grad_(True) for t in p]
    loss, grads = 0.0, None
    for a in range(0, B, rows):
        share = min(rows, B - a) / B
        with torch.enable_grad():
            part = model.loss(unflatten(like, view), cfg,
                              {key: v[a:a + rows] for key, v in batch.items()})
            g = torch.autograd.grad(part, view)
        loss = loss + share * part.detach().to(F32)
        g = [share * t.to(F32) for t in g]
        grads = g if grads is None else [s + t for s, t in zip(grads, g)]
        del part, g
    return loss, grads


def local_train(model, cfg, x, like, batch, kn: int, gamma, compute,
                rows: int):
    """One worker's K_max steps from the f32 leaves ``x`` -> (its leaves,
    its mean loss, the norm of each leaf's first gradient); each step's
    gradient over blocks of ``rows`` rows."""
    p, losses, g0 = list(x), [], None
    K = next(iter(batch.values())).shape[0]
    for k in range(K):
        loss, grads = _loss_grad(model, cfg, like, p,
                                 {key: v[k] for key, v in batch.items()},
                                 rows, compute)
        if g0 is None:
            g0 = [_norm(g) for g in grads]
        step = gamma * (1.0 if k < kn else 0.0)
        p = [w - step * g for w, g in zip(p, grads)]
        del grads
        losses.append(loss)
    return p, torch.stack(losses).mean(), g0


def aggregate_apply(x, trained, words, gamma, s0: int, sn: int):
    """x̂' from x̂ (f32 leaves) and the workers' trained leaves; ``words``
    (fl + 1, 2) uint32, the workers' key words then the server's."""
    fl = len(trained)
    fl_t = torch.tensor(float(fl), dtype=F32, device=x[0].device)
    out = []
    for i, xi in enumerate(x):
        n = xi.numel()
        d = torch.stack([(w[i] - xi).reshape(-1) for w in trained]) / gamma
        u = torch.stack([uniform(n, seed_from(words[w], i), xi.device)
                         for w in range(fl)])
        lvl, nrm = quantize(d, u, sn)
        del d, u
        scale = nrm / torch.full_like(nrm, float(sn))
        agg = lvl[0] * scale[0] / fl_t
        for w in range(1, fl):
            agg = agg + lvl[w] * scale[w] / fl_t
        del lvl
        u0 = uniform(n, seed_from(words[-1], 1000 + i), xi.device)
        lvl0, nrm0 = quantize(agg[None], u0[None], s0)
        scale0 = nrm0 / torch.full_like(nrm0, float(s0))
        out.append((xi.reshape(-1) + (gamma * lvl0[0]) * scale0)
                   .reshape(xi.shape))
    return out


def rounds(model, cfg, like, x0, batch_of, words_of, gamma: float, job,
           s0: int, sn: int, n_rounds: int, compute) -> dict:
    """``n_rounds`` rounds from the f32 leaves ``x0`` (kept unchanged):
    ``batch_of(r)`` the round's batch (leaves (fl, K_max, ...)),
    ``words_of(r)`` its key words -> {"loss": each round's mean loss,
    "change": each round's per-leaf ‖x̂_r - x̂_0‖, "grad": the norm of
    each leaf of worker 0's first gradient}."""
    g = torch.tensor(np.float32(gamma), dtype=F32, device=x0[0].device)
    x, out = list(x0), {"loss": [], "change": [], "grad": None}
    for r in range(n_rounds):
        batch, words = batch_of(r), words_of(r)
        trained, losses = [], []
        for w in range(job["fl"]):
            p, loss, g0 = local_train(model, cfg, x, like,
                                      {k: v[w] for k, v in batch.items()},
                                      job["Kn"][w], g, compute,
                                      job.get("reference_rows",
                                              job["batch"]))
            trained.append(p)
            losses.append(loss)
            if out["grad"] is None:
                out["grad"] = g0
        del batch
        x = aggregate_apply(x, trained, words, g, s0, sn)
        del trained
        out["loss"].append(float(torch.stack(losses).mean()))
        out["change"].append([_norm(a - b) for a, b in zip(x, x0)])
    return out
