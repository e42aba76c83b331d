"""Federated data plumbing: per-worker partitioning (Assumption 2: IID) and
mini-batch index draws.

The JAX package draws each worker's mini-batch inside its jitted round with
``jax.random``; here a round's indices for all workers and local steps are
one (N, K_max, B) draw from a ``torch.Generator`` on the data's device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["partition_iid", "sample_indices"]


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
