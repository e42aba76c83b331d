"""Synthetic data generators (fully offline, deterministic).

* ``mnist_like`` — the paper-repro dataset: a 10-class, 784-dim image-like
  Gaussian mixture (class templates are smoothed random blobs), 60k
  samples, matching Sec. VII's MNIST setup in shape and difficulty class.
  NumPy-seeded, the same arithmetic as the JAX package's copy, so the
  arrays are identical.
* ``token_batches`` / ``lm_batch`` — LM token sequences with local
  statistical structure (a random Markov backbone + noise) so cross
  entropy falls during a run.  The transition matrix (``_markov_matrix``)
  is the JAX package's, equal for a seed; each batch's NumPy walk is
  seeded from a ``torch.Generator`` draw where the JAX package draws from
  ``jax.random``.  The matrix is vocab^2 float64 (185 GB at qwen3's
  151,936 tokens), so the walk keeps only each token's successors and
  their extra mass (``_markov_successors``, vocab x 8) and builds the
  current tokens' rows as it steps (``_markov_rows``), the matrix's rows
  bit for bit.  ``uniform_lm_batch`` draws uniform tokens on the device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["mnist_like", "token_batches", "lm_batch", "uniform_lm_batch"]


def _markov_successors(vocab: int, seed: int, branching: int = 8):
    """Each token's ``branching`` successors and the mass they add to its
    row, drawn as the JAX package draws its matrix -> (nxt (vocab, b)
    int64, extra (vocab, b) float64)."""
    rng = np.random.default_rng(seed)
    nxt = np.empty((vocab, branching), np.int64)
    extra = np.empty((vocab, branching))
    for v in range(vocab):
        nxt[v] = rng.choice(vocab, size=branching, replace=False)
        extra[v] = rng.dirichlet(np.ones(branching)) * branching
    return nxt, extra


def _markov_rows(succ, vocab: int, tokens: np.ndarray) -> np.ndarray:
    """The transition matrix's rows of ``tokens`` (n,) -> (n, vocab)."""
    nxt, extra = succ
    rows = np.full((len(tokens), vocab), 1e-3)
    for r, v in enumerate(tokens):
        rows[r, nxt[v]] += extra[v]
    rows /= rows.sum(axis=1, keepdims=True)
    return rows


def _markov_matrix(vocab: int, seed: int, branching: int = 8) -> np.ndarray:
    return _markov_rows(_markov_successors(vocab, seed, branching), vocab,
                        np.arange(vocab))


def lm_batch(generator: torch.Generator, batch: int, seq: int, vocab: int,
             succ) -> dict:
    """One (tokens, labels) batch from the Markov backbone (``succ`` from
    :func:`_markov_successors`): int32 (batch, seq) tensors on the host,
    the walk seeded by one draw of ``generator``."""
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    rng = np.random.default_rng(seed)
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    for t in range(seq):
        u = rng.random(batch)
        rows = _markov_rows(succ, vocab, toks[:, t])
        cum = np.cumsum(rows, axis=1, out=rows)
        toks[:, t + 1] = (cum > u[:, None]).argmax(axis=1)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def token_batches(seed: int, batch: int, seq: int, vocab: int
                  ) -> Iterator[dict]:
    """Endless Markov-backbone batches for ``seed`` (a host generator)."""
    succ = _markov_successors(vocab, seed)
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield lm_batch(gen, batch, seq, vocab, succ)


def uniform_lm_batch(generator: torch.Generator, shape: tuple,
                     vocab: int) -> dict:
    """(tokens, labels) of uniform tokens shaped ``shape + (seq,)`` with
    ``shape[-1]`` = seq, labels the next tokens, drawn on the generator's
    device."""
    *lead, seq = shape
    toks = torch.randint(0, vocab, (*lead, seq + 1), generator=generator,
                         device=generator.device, dtype=torch.int64)
    toks = toks.to(torch.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def mnist_like(n: int = 60_000, n_classes: int = 10, dim: int = 784,
               seed: int = 0, noise: float = 0.35):
    """(X (n, 784) f32 in [0,1]-ish, y (n,) int32).  Deterministic."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(dim))
    # class templates: superpositions of smooth random blobs
    templates = np.zeros((n_classes, side, side), np.float32)
    yy, xx = np.mgrid[0:side, 0:side]
    for c in range(n_classes):
        for _ in range(4):
            cy, cx = rng.uniform(4, side - 4, 2)
            sig = rng.uniform(2.0, 5.0)
            amp = rng.uniform(0.6, 1.0)
            templates[c] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                         / (2 * sig**2))
    templates = templates.reshape(n_classes, dim)
    templates /= templates.max(axis=1, keepdims=True)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    X = templates[y] + noise * rng.standard_normal((n, dim)).astype(np.float32)
    return np.clip(X, 0.0, 1.3).astype(np.float32), y
