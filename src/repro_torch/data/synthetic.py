"""Synthetic data (fully offline, deterministic): ``mnist_like``, the
paper-repro dataset — a 10-class, 784-dim image-like Gaussian mixture
(class templates are smoothed random blobs), 60k samples, matching Sec.
VII's MNIST setup in shape and difficulty class.  NumPy-seeded, the same
arithmetic as the JAX package's copy, so the arrays are identical.

The LM token streams come with the LM stack (ROADMAP.md, Queue 1, item 10).
"""
from __future__ import annotations

import numpy as np

__all__ = ["mnist_like"]


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
