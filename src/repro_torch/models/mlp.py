"""The paper's Sec.-VII model: a 784-128-10 two-layer neural network with
sigmoid hidden activation, softmax output and cross-entropy loss
(D = 784*128 + 128 + 128*10 + 10 = 101,770 parameters).

Parameters keep the JAX package's layout (``w1`` (784, 128), ``b1``,
``w2`` (128, 10), ``b2``; ``X @ w1``), so weights carry across with
:func:`params_from_jax`.  The functions take parameters with any leading
batch dimensions — (N, 784, 128) and so on for N workers training side by
side — and the matching (N, B, 784) inputs.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import resolve_device

__all__ = ["init_params", "params_from_jax", "predict", "loss", "accuracy",
           "MLP", "PARAM_DIM", "KEYS", "estimate_constants"]

PARAM_DIM = 784 * 128 + 128 + 128 * 10 + 10
#: the JAX package's flat order: ``jax.tree.leaves`` sorts dict keys
KEYS = ("b1", "b2", "w1", "w2")


def init_params(generator: torch.Generator) -> dict:
    """Fresh parameters on the generator's device."""
    dev = generator.device
    return {
        "w1": torch.randn(784, 128, generator=generator, device=dev)
        / np.sqrt(784),
        "b1": torch.zeros(128, device=dev),
        "w2": torch.randn(128, 10, generator=generator, device=dev)
        / np.sqrt(128),
        "b2": torch.zeros(10, device=dev),
    }


def params_from_jax(params: dict, device="cuda") -> dict:
    """The JAX package's MLP parameters (as NumPy arrays) as this package's
    tensors on ``device`` (the card unless the caller asks for the CPU):
    the layouts are the same, so this is a copy."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.array(params[k], np.float32), device=dev)
            for k in KEYS}


def predict(params: dict, X: torch.Tensor) -> torch.Tensor:
    h = torch.sigmoid(X @ params["w1"] + params["b1"].unsqueeze(-2))
    return h @ params["w2"] + params["b2"].unsqueeze(-2)


def loss(params: dict, batch) -> torch.Tensor:
    """Mean cross-entropy over the batch axis (one value per model)."""
    X, y = batch
    logits = predict(params, X)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.unsqueeze(-1).long()).squeeze(-1)
    return (logz - gold).mean(-1)


def accuracy(params: dict, X: torch.Tensor, y: torch.Tensor) -> float:
    with torch.no_grad():
        hit = torch.argmax(predict(params, X), -1) == y
    return float(hit.to(torch.float32).mean())


class MLP(nn.Module):
    """The network as a module (parameters in the JAX layout), for the
    single-model pre-training of :func:`estimate_constants`."""

    def __init__(self, params: dict):
        super().__init__()
        for k in KEYS:
            self.register_parameter(k, nn.Parameter(params[k].detach().clone()))

    def params(self) -> dict:
        return {k: getattr(self, k) for k in KEYS}

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return predict(self.params(), X)


def _flat_grad(params: dict, X, y) -> torch.Tensor:
    from ..core.genqsgd import flatten_like
    ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        gs = torch.autograd.grad(loss(ps, (X, y)), [ps[k] for k in KEYS])
    return flatten_like(dict(zip(KEYS, gs)))


def estimate_constants(X: torch.Tensor, y: torch.Tensor,
                       generator: torch.Generator = None,
                       n_iters: int = 300, batch: int = 256, lr: float = 0.5,
                       n_probe: int = 20, params: dict = None,
                       idx: torch.Tensor = None) -> dict:
    """Pre-training estimates of (L, sigma, G, f_gap) — Sec. IV-A.

    L: max ||∇f(x)-∇f(y)|| / ||x-y|| over probe pairs along the SGD path;
    sigma: per-sample gradient deviation bound (Assumption 4);
    G: per-sample gradient second-moment bound (Assumption 5);
    f_gap: f(x^(1)) - f(x_pretrained)  (upper bound on f(x1) - f*).

    ``params`` (the start point) and ``idx`` ((n_iters, batch) mini-batch
    indices) are drawn from ``generator`` unless given.
    """
    from torch.func import grad, vmap

    from ..core.genqsgd import flatten_like

    if params is None:
        params = init_params(generator)
    if idx is None:
        idx = torch.randint(0, X.shape[0], (n_iters, batch),
                            generator=generator, device=X.device)
    with torch.no_grad():
        f0 = float(loss(params, (X[:4096], y[:4096])))

    model = MLP(params)
    snapshots = []
    for it in range(n_iters):
        b = idx[it]
        gs = torch.autograd.grad(loss(model.params(), (X[b], y[b])),
                                 list(model.parameters()))
        with torch.no_grad():
            for p, g in zip(model.parameters(), gs):
                p.sub_(lr * g)
        if it % (n_iters // n_probe) == 0:
            snapshots.append({k: v.detach().clone()
                              for k, v in model.params().items()})
    final = {k: v.detach() for k, v in model.params().items()}
    with torch.no_grad():
        f_star = float(loss(final, (X[:8192], y[:8192])))

    # Lipschitz probe over snapshot pairs
    Xp, yp = X[:4096], y[:4096]
    L = 0.0
    gs = [_flat_grad(s, Xp, yp) for s in snapshots]
    xs = [flatten_like(s) for s in snapshots]
    for i in range(len(snapshots) - 1):
        num = float(torch.linalg.vector_norm(gs[i + 1] - gs[i]))
        den = float(torch.linalg.vector_norm(xs[i + 1] - xs[i]))
        if den > 1e-9:
            L = max(L, num / den)

    # sigma, G from per-sample grads at a few snapshots
    per_sample = vmap(grad(lambda p, x, t: loss(p, (x[None], t[None]))),
                      in_dims=(None, 0, 0))
    sig2, G2 = 0.0, 0.0
    for s in snapshots[:: max(1, len(snapshots) // 4)]:
        sample = flatten_like(per_sample(s, X[:512], y[:512]), lead=1)
        mean_g = sample.mean(dim=0)
        sig2 = max(sig2, float(torch.mean(
            torch.sum((sample - mean_g) ** 2, -1))))
        G2 = max(G2, float(torch.max(torch.sum(sample ** 2, -1))))
    return {
        "L": L,
        "sigma": float(np.sqrt(sig2)),
        "G": float(np.sqrt(G2)),
        "f_gap": max(f0 - f_star, 1e-3),
        "f0": f0,
        "f_star": f_star,
    }
