"""GenQSGD (Algorithm 1) in PyTorch — the single-process reference runtime.

The N workers train side by side as a leading batch dimension of every
parameter, and the round is a pure function of its draws::

    x_new, metrics = alg.round(x_hat_flat, idx, u_workers, u_server, gamma)

with ``idx`` the (N, K_max, B) mini-batch indices, ``u_workers`` the
(N, D') uniform noise of the worker quantizers and ``u_server`` the (D',)
noise of the server's, so a test can inject the JAX package's draws.  D' is
the quantized message's length: D, or ``next_pow2(D)`` for the rotated
codec (``msg_dim``).  ``run`` draws them from a seeded ``torch.Generator``
on the device.

Heterogeneous local iteration counts ``K_n`` are handled the way the paper's
analysis does (eqs. (6)-(8)): every worker runs ``K_max = max_n K_n`` local
steps and workers whose ``K_n`` is exhausted perform *virtual* (masked,
no-op) updates.

Quantization follows Algorithm 1 lines 3-10, on the flattened D-dimensional
model delta:
  * worker n sends  Q((x_n^{(k0,K_n)} - x̂^{(k0)}) / γ^{(k0)}; s_n)     (5)
    — one batched encode of all N rows (kernels K1, K2);
  * the server averages these into Δx̂^{(k0)} and multicasts Q(Δx̂; s_0)
    — one encode (K1, K2);
  * every node recovers x̂^{(k0+1)} = x̂^{(k0)} + γ^{(k0)} Q(Δx̂; s_0)   (3)
    — the fused dequantize + apply (K3).

The family hooks of the JAX package ride on the same round: weighted
aggregation ``Δx̂ = Σ_n w_n Q(Δ_n)`` (``agg_weights``), GQFedWAvg's
normalized-momentum local update (``momentum``/``normalize``) and the
rotated codec (``codec_kind="rotated"``: rotate then K1/K2 per encode, the
server apply in plain PyTorch).

The flat vector orders the parameters by sorted name (b1, b2, w1, w2), as
``jax.tree.leaves`` does in the JAX package, so the same noise lands on the
same coordinates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import not_ported
from ..compress import make_codec
from ..data.federated import sample_indices
from ..families import check_agg_weights, check_momentum
from .step_rules import StepRule

__all__ = ["GenQSGDConfig", "GenQSGD", "flatten_like", "unflatten_like"]


def flatten_like(tree: dict, lead: int = 0) -> torch.Tensor:
    """Ravel a dict of tensors, sorted by name, into one f32 vector — or,
    with ``lead`` leading batch dimensions, one vector per batch entry."""
    keys = sorted(tree)
    shape = tree[keys[0]].shape[:lead]
    return torch.cat([tree[k].reshape(*shape, -1).to(torch.float32)
                      for k in keys], dim=-1)


def unflatten_like(flat: torch.Tensor, shapes: dict) -> dict:
    """Inverse of :func:`flatten_like`: ``shapes`` maps names to the
    per-model shapes; leading dimensions of ``flat`` carry through."""
    out, off = {}, 0
    lead = flat.shape[:-1]
    for k in sorted(shapes):
        n = int(np.prod(shapes[k])) if shapes[k] else 1
        out[k] = flat[..., off:off + n].reshape(*lead, *shapes[k])
        off += n
    return out


@dataclasses.dataclass(frozen=True)
class GenQSGDConfig:
    """Algorithm parameters (K, B, Γ) + quantizer parameters (s_0, s_n).

    The family hooks ride along as plain fields: ``agg_weights`` turns the
    server mean into a weighted sum, ``momentum``/``normalize`` select
    GQFedWAvg's normalized momentum local update, ``codec_kind`` the
    quantizer preconditioner.  The defaults are GenQSGD (Algorithm 1).
    Sampling, faults and per-bucket norms raise (ROADMAP.md, Queue 1).
    """
    K0: int                      # global iterations
    Kn: Tuple[int, ...]          # per-worker local iterations (len N)
    B: int                       # mini-batch size
    step_rule: StepRule          # Γ generator
    s0: Optional[int] = None     # server quantizer (None = s = ∞)
    sn: Optional[Sequence[Optional[int]]] = None  # per-worker quantizers
    bucket: Optional[int] = None  # per-bucket-norm quantization (q_dim)
    agg_weights: Optional[Tuple[float, ...]] = None  # w_n (None = mean)
    momentum: float = 0.0        # local-update momentum beta
    normalize: bool = False      # normalized (unit-direction) local updates
    codec_kind: str = "qsgd"     # make_codec kind
    sampling_S: Optional[int] = None  # per-round cohort size (None = full)
    sampling_p: Optional[Tuple[float, ...]] = None  # base probs (None = unif)
    seed: Optional[int] = None   # cohort/fault rng seed
    faults: Optional[object] = None  # FaultSpec (None = no faults)

    def __post_init__(self):
        if self.bucket is not None:
            raise not_ported("per-bucket-norm quantization", 2)
        if self.agg_weights is not None:
            object.__setattr__(self, "agg_weights",
                               check_agg_weights(self.agg_weights,
                                                 len(self.Kn)))
        check_momentum(self.momentum)
        if self.sampling_S is not None or self.sampling_p is not None:
            raise not_ported("client sampling in the runtime", 6)
        if self.faults is not None:
            raise not_ported("fault injection in the runtime", 6)

    @property
    def N(self) -> int:
        return len(self.Kn)

    @property
    def K_max(self) -> int:
        return int(max(self.Kn))

    def worker_s(self) -> Sequence[Optional[int]]:
        return self.sn if self.sn is not None else [None] * self.N


class GenQSGD:
    """The round function and the driver loop.

    Args:
      loss_fn: ``loss_fn(params, (X, y)) -> per-model loss``; params carry
        a leading worker dimension and the batch is (N, B, ...).
      data: ``(X, y)`` with leading axis N (per-worker shards), on the
        device the run uses.
      shapes: name -> per-model parameter shape.
      config: the (K, B, Γ, s) parameterization and the family hooks.

    The codecs run on the kernel backend: the CUDA kernels for tensors on
    the card, their plain versions for tensors on the CPU.
    """

    def __init__(self, loss_fn: Callable, data, shapes: dict,
                 config: GenQSGDConfig):
        self.loss_fn = loss_fn
        self.X, self.y = data
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.cfg = config
        self.device = self.X.device
        if self.X.shape[0] != config.N:
            raise ValueError(f"data has {self.X.shape[0]} worker shards, "
                             f"config has N={config.N}")
        self.n_local = int(self.X.shape[1])
        self.dim = sum(int(np.prod(s)) for s in self.shapes.values())
        self._kn = torch.as_tensor(config.Kn, device=self.device)
        self._rows = torch.arange(config.N, device=self.device)[:, None]
        kind = config.codec_kind
        self.worker_codecs = [make_codec(s, backend="cuda", kind=kind)
                              for s in config.worker_s()]
        self.server_codec = make_codec(config.s0, backend="cuda", kind=kind)
        #: length of a quantized message (the rotated codec pads to 2^k)
        self.msg_dim = max(c.padded_dim(self.dim)
                           for c in self.worker_codecs + [self.server_codec])
        self._agg = None
        if config.agg_weights is not None:
            w = torch.tensor(config.agg_weights, dtype=torch.float32,
                             device=self.device)
            self._agg = w / w.sum()

    # ------------------------------------------------------------------
    def _local_train(self, x_hat: dict, idx: torch.Tensor,
                     gamma: float) -> dict:
        """K_max masked local steps for all N workers at once.

        Plain mini-batch SGD by default; with ``momentum``/``normalize``
        each active step updates a momentum buffer ``v <- beta v +
        (1 - beta) g`` and moves along ``v`` (unit-normalized over the whole
        model, per worker, when ``normalize``), in the JAX package's float
        expressions.  Virtual (masked) steps leave both ``x`` and ``v``
        untouched."""
        cfg = self.cfg
        N = cfg.N
        keys = sorted(x_hat)
        x = {k: x_hat[k].expand(N, *x_hat[k].shape) for k in keys}
        plain = cfg.momentum == 0.0 and not cfg.normalize
        if not plain:
            beta = torch.tensor(cfg.momentum, dtype=torch.float32,
                                device=self.device)
            one_minus_beta = torch.ones_like(beta) - beta   # in f32, as JAX
            v = {k: torch.zeros_like(x[k]) for k in keys}
        for k in range(cfg.K_max):
            b = idx[:, k]                                   # (N, B)
            batch = (self.X[self._rows, b], self.y[self._rows, b])
            xs = [x[n].detach().requires_grad_(True) for n in keys]
            with torch.enable_grad():
                g = torch.autograd.grad(
                    self.loss_fn(dict(zip(keys, xs)), batch).sum(), xs)
            active = (k < self._kn).to(torch.float32)        # (N,)
            if plain:
                step = gamma * active
                x = {n: p.detach() - _lead(step, p) * gg
                     for n, p, gg in zip(keys, xs, g)}
                continue
            v = {n: v[n] + _lead(active, v[n])
                 * (beta * v[n] + one_minus_beta * gg - v[n])
                 for n, gg in zip(keys, g)}
            scale = gamma * active
            if cfg.normalize:
                vn = torch.sqrt(sum(torch.sum(torch.square(v[n]),
                                              dim=tuple(range(1, v[n].dim())))
                                    for n in keys))
                scale = scale / torch.clamp_min(vn, 1e-12)
            x = {n: p.detach() - _lead(scale, p) * v[n]
                 for n, p in zip(keys, xs)}
        return x

    def worker_deltas(self, x_hat_flat: torch.Tensor, idx: torch.Tensor,
                      gamma: float) -> torch.Tensor:
        """(N, D): each worker's normalized model delta after its local
        steps, (x_n - x̂) / γ — the messages of (5) before quantization."""
        x_hat = unflatten_like(x_hat_flat, self.shapes)
        x_workers = self._local_train(x_hat, idx, gamma)
        return (flatten_like(x_workers, lead=1) - x_hat_flat) / gamma

    def _upload(self, d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """(5): each worker's quantized normalized delta, dequantized."""
        codecs = self.worker_codecs
        if len(set(codecs)) == 1:   # one batched encode of all N rows
            return codecs[0].quantize_dequantize(d, u)
        return torch.stack([c.quantize_dequantize(d[i], u[i])
                            for i, c in enumerate(codecs)])

    def round(self, x_hat_flat: torch.Tensor, idx: torch.Tensor,
              u_workers: torch.Tensor, u_server: torch.Tensor, gamma):
        """One global iteration (Algorithm 1, lines 3-10) -> (x̂_new flat,
        metrics of device scalars)."""
        g = float(np.float32(gamma))     # the step size as the f32 it is
        deltas = self._upload(self.worker_deltas(x_hat_flat, idx, g),
                              u_workers)
        if self._agg is None:
            delta_hat = deltas.mean(dim=0)
        else:                            # general weighted aggregation
            delta_hat = torch.tensordot(self._agg, deltas, dims=1)
        c0 = self.server_codec
        lvl0, norm0 = c0.encode(delta_hat, u_server)
        new_flat = c0.decode_apply(x_hat_flat, lvl0, norm0, g)
        metrics = {"delta_norm": torch.linalg.vector_norm(delta_hat),
                   "update_norm": torch.linalg.vector_norm(
                       new_flat - x_hat_flat)}
        return new_flat, metrics

    # ------------------------------------------------------------------
    def run(self, x0_flat: torch.Tensor, generator: torch.Generator,
            eval_fn=None, eval_every: int = 10):
        """Full K0-round driver -> (x* flat, history).  Each round draws
        its mini-batch indices and quantizer noise from ``generator``."""
        cfg = self.cfg
        gammas = cfg.step_rule.sequence(cfg.K0)
        N, M = cfg.N, self.msg_dim
        x = x0_flat
        history = []
        for k0 in range(cfg.K0):
            idx = sample_indices(generator, self.n_local, N, cfg.K_max,
                                 cfg.B)
            u_w = torch.rand((N, M), generator=generator, device=self.device)
            u_s = torch.rand((M,), generator=generator, device=self.device)
            x, m = self.round(x, idx, u_w, u_s, gammas[k0])
            if eval_fn is not None and (k0 % eval_every == 0
                                        or k0 == cfg.K0 - 1):
                e = eval_fn(x)
                e.update({k: float(v) for k, v in m.items()})
                e["k0"] = k0
                history.append(e)
        return x, history


def _lead(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-worker (N,) tensor shaped to broadcast against ``like``."""
    return t.view(-1, *([1] * (like.dim() - 1)))
