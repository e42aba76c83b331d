"""Federated data plumbing: per-worker partitioning (Assumption 2: IID),
mini-batch index draws, and round-batch assembly for the federated LM
runtime.

The JAX package draws each worker's mini-batch inside its jitted round with
``jax.random``; here a round's indices for all workers and local steps are
one (N, K_max, B) draw from a ``torch.Generator`` on the data's device.
The LM runtime consumes batches with leading (fl, K_max, B) dims — one
mini-batch per local step per worker (``round_batches``).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

__all__ = ["partition_iid", "sample_indices", "round_batches"]


def partition_iid(X: np.ndarray, y: np.ndarray, n_workers: int, seed: int = 0):
    """Shuffle + equal split (the paper's IID assumption)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(X))
    Xs, ys = X[perm], y[perm]
    per = len(X) // n_workers
    return ([Xs[i * per:(i + 1) * per] for i in range(n_workers)],
            [ys[i * per:(i + 1) * per] for i in range(n_workers)])


def sample_indices(generator: torch.Generator, n_local: int, N: int,
                   K: int, B: int) -> torch.Tensor:
    """Uniform with-replacement mini-batch indices into each worker's shard:
    (N, K, B) int64 on the generator's device."""
    return torch.randint(0, n_local, (N, K, B), generator=generator,
                         device=generator.device)


def round_batches(stream, n_workers: int, k_max: int) -> Iterator[Dict]:
    """Stack per-worker, per-local-step LM batches (dicts of tensors with a
    leading batch dim, from ``stream``) into the runtime layout (fl, K_max,
    B, ...), worker-major as the JAX package."""
    while True:
        steps = [[next(stream) for _ in range(k_max)]
                 for _ in range(n_workers)]
        yield {k: torch.stack([torch.stack([steps[w][s][k]
                                            for s in range(k_max)])
                               for w in range(n_workers)])
               for k in steps[0][0]}
