"""Training tasks for ``Scenario.run``.

A *reference task* bundles what the single-process runtime (Algorithm 1)
needs:

  dim                     model dimension (what ``EdgeSystem.dim`` should be)
  device                  where the data and the run live
  init_params(generator)  fresh model parameters
  loss(params, batch)     per-model training loss
  make_data(N)            per-worker data (X, y) with leading axis N
  metrics(params)         evaluation dict (used for history + final report)

Provided: :class:`MNISTTask`, the paper's Sec.-VII 784-128-10 MLP on the
synthetic MNIST-like set, and :class:`QuadraticTask`, a tiny linear
regression for tests and smoke runs.  :class:`SpmdTask` carries what the
federated LM runtime needs instead (model api, arch config, transport,
device, batch iterator).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.convergence import MLProblemConstants
from ..data.federated import partition_iid
from ..models import mlp

__all__ = ["MNISTTask", "QuadraticTask", "SpmdTask"]


class MNISTTask:
    """The Sec.-VII task: two-layer MLP on the 60k-sample MNIST-like set.

    The data lives on ``device`` (the card unless the caller asks for the
    CPU): 50,000 training samples of 784 f32 are about 157 MB.
    """

    dim = mlp.PARAM_DIM
    shapes = {"w1": (784, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)}

    def __init__(self, n_train: int = 50000, seed: int = 0,
                 eval_samples: int = 2048, device="cuda"):
        self.n_train = n_train
        self.seed = seed
        self.eval_samples = eval_samples
        self.device = resolve_device(device)
        self._data = None
        self._full = None

    # -- data ----------------------------------------------------------
    def _load(self):
        if self._data is None:
            from ..data.synthetic import mnist_like
            X, y = mnist_like(seed=self.seed)
            n = self.n_train
            self._full = (X, y)
            self._data = (X[:n], y[:n], self._tensor(X[n:]),
                          self._tensor(y[n:]))
        return self._data

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        dt = torch.int64 if a.dtype.kind == "i" else t.dtype
        return t.to(device=self.device, dtype=dt)

    def make_data(self, N: int):
        Xtr, ytr, _, _ = self._load()
        Xw, yw = partition_iid(Xtr, ytr, N)
        return self._tensor(np.stack(Xw)), self._tensor(np.stack(yw))

    # -- model ---------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> dict:
        return mlp.init_params(generator)

    loss = staticmethod(mlp.loss)

    def metrics(self, params) -> dict:
        _, _, Xte, yte = self._load()
        if isinstance(params, torch.Tensor):      # a flat model vector
            from ..core.genqsgd import unflatten_like
            params = unflatten_like(params, self.shapes)
        k = self.eval_samples
        with torch.no_grad():
            eval_loss = float(mlp.loss(params, (Xte[:k], yte[:k])))
        return {"eval_loss": eval_loss,
                "test_acc": mlp.accuracy(params, Xte, yte)}

    # -- pre-training constants (Sec. IV-A) ----------------------------
    def estimate_constants(self, N: int, seed: int = 0,
                           n_iters: int = 300) -> MLProblemConstants:
        """Probe (L, sigma, G, f_gap) by pre-training (Sec. IV-A) on the
        full dataset; the start point and the mini-batches come from a
        ``torch.Generator`` seeded ``seed`` on the task's device."""
        self._load()
        X, y = (self._tensor(a) for a in self._full)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        d = mlp.estimate_constants(X, y, gen, n_iters=n_iters)
        return MLProblemConstants(L=d["L"], sigma=d["sigma"], G=d["G"],
                                  f_gap=d["f_gap"], N=N)


class QuadraticTask:
    """Noisy linear regression: params {"w": (dim,)}, closed-form optimum.

    Small enough that a full optimized K0 executes in seconds — the task
    the end-to-end Plan→RunReport tests drive.  ``true_w``, the inputs and
    the targets come from NumPy generators seeded by ``seed`` (the JAX
    package draws them with ``jax.random``, which torch cannot reproduce);
    ``data=(true_w, X, T)`` takes given arrays instead, X of shape (N,
    per_worker, dim) and T of shape (N, per_worker), so a test can build
    this task from the JAX package's.
    """

    def __init__(self, dim: int = 8, per_worker: int = 64,
                 noise: float = 0.01, seed: int = 0, device="cuda",
                 data=None):
        self.device = resolve_device(device)
        self.noise = noise
        self.seed = seed
        self._given = None
        if data is None:
            true_w = np.random.default_rng(seed).standard_normal(dim)
        else:
            true_w, X, T = (np.array(a, np.float32) for a in data)
            dim, per_worker = int(true_w.shape[0]), int(X.shape[1])
            if X.shape[2:] != (dim,) or T.shape != X.shape[:2]:
                raise ValueError(f"data shapes w {true_w.shape}, X {X.shape}, "
                                 f"T {T.shape} do not fit (N, per_worker, "
                                 f"dim)")
            self._given = (X, T)
        self.dim = dim
        self.per_worker = per_worker
        self.shapes = {"w": (dim,)}
        self.true_w = torch.as_tensor(np.asarray(true_w, np.float32),
                                      device=self.device)

    def make_data(self, N: int):
        if self._given is not None:
            X, T = self._given
            if X.shape[0] != N:
                raise ValueError(f"the given data has {X.shape[0]} workers, "
                                 f"asked for N={N}")
        else:
            X = np.random.default_rng((self.seed, 1)).standard_normal(
                (N, self.per_worker, self.dim)).astype(np.float32)
            eps = np.random.default_rng((self.seed, 2)).standard_normal(
                (N, self.per_worker)).astype(np.float32)
            T = X @ self.true_w.cpu().numpy() + np.float32(self.noise) * eps
        return (torch.as_tensor(X, device=self.device),
                torch.as_tensor(T, device=self.device))

    def init_params(self, generator: torch.Generator) -> dict:
        del generator
        return {"w": torch.zeros(self.dim, device=self.device)}

    @staticmethod
    def loss(params: dict, batch) -> torch.Tensor:
        """Mean squared error over the batch axis (one value per model)."""
        X, t = batch
        pred = torch.matmul(X, params["w"].unsqueeze(-1)).squeeze(-1)
        return torch.square(pred - t).mean(-1)

    def metrics(self, params) -> dict:
        w = params if isinstance(params, torch.Tensor) else params["w"]
        with torch.no_grad():
            return {"err": float(torch.linalg.vector_norm(w - self.true_w))}


@dataclasses.dataclass
class SpmdTask:
    """What ``Scenario.run(backend="spmd")`` needs beyond the Plan: a model
    api (``init_params``/``loss_train``), its arch config, an iterator of
    round batches shaped (fl, K_max, B_local, ...), the transport of the
    fl workers (None: all of them in this process) and the device the
    model lives on (the card unless the caller asks for the CPU)."""

    api: object
    arch: object                 # repro_torch.configs.base.ArchConfig
    batches: Iterator
    eval_fn: Optional[Callable] = None
    checkpoint_dir: Optional[str] = None
    transport: object = None     # repro_torch.fed.transport (None = local)
    device: object = "cuda"
