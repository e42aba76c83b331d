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

With per-bucket norms (``bucket``, the Plan's ``q_dim``) every message is
quantized in buckets of that many coordinates: K1/K2 run on the
(N * n_buckets, bucket) rows of the worker uploads and the (n_buckets,
bucket) rows of the server's message, and the apply is K3b, one norm per
bucket.

The family hooks of the JAX package ride on the same round: weighted
aggregation ``Δx̂ = Σ_n w_n Q(Δ_n)`` (``agg_weights``), GQFedWAvg's
normalized-momentum local update (``momentum``/``normalize``) and the
rotated codec (``codec_kind="rotated"``: rotate then K1/K2 per encode, the
server apply in plain PyTorch).  Under client sampling or fault injection
the round takes a length-N weight vector ``u`` and aggregates
``Δx̂ = Σ_n u_n Q(Δ_n)`` (Horvitz-Thompson); ``run`` draws the cohorts and
the faults on the host from NumPy streams seeded by ``cfg.seed``, so their
traces do not depend on the device.  All N workers still train and encode
(one batched K1/K2 launch of N rows); a worker outside the round's
delivered cohort gets ``u_n = 0``, as in the JAX package.

The flat vector orders the parameters by sorted name (b1, b2, w1, w2), as
``jax.tree.leaves`` does in the JAX package, so the same noise lands on the
same coordinates.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compress import make_codec
from ..data.federated import sample_indices
from ..obs import REGISTRY as _METRICS
from ..obs.metrics import GLOBAL_SWITCH as _OBS_ON
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
    quantizer preconditioner; ``sampling_S``/``sampling_p`` draw a seeded
    cohort each round and ``faults`` (a
    :class:`~repro_torch.faults.FaultSpec`) seeded faults.  The defaults
    are GenQSGD (Algorithm 1).  ``bucket`` gives every quantizer one norm
    per bucket of that many coordinates (QSGD bucketing, the Plan's
    ``q_dim``).
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
    seed: Optional[int] = None   # cohort/fault rng seed (None = OS entropy)
    faults: Optional[object] = None  # FaultSpec (None = no faults)

    def __post_init__(self):
        from ..families import check_agg_weights, check_momentum  # cycle
        if self.agg_weights is not None:
            object.__setattr__(self, "agg_weights",
                               check_agg_weights(self.agg_weights,
                                                 len(self.Kn)))
        check_momentum(self.momentum)
        if self.sampling_p is not None and self.sampling_S is None:
            raise ValueError("sampling_p given without sampling_S")
        if self.sampling_S is not None:
            from ..sampling.base import check_probs  # cycle
            S = int(self.sampling_S)
            if not 1 <= S <= self.N:
                raise ValueError(f"sampling_S={S} outside [1, N={self.N}]")
            object.__setattr__(self, "sampling_S", S)
            if self.sampling_p is not None:
                p = check_probs(self.sampling_p, self.N)
                if S * max(p) > 1.0 + 1e-9:
                    raise ValueError(
                        f"inclusion probability S*max(p)={S * max(p):.4g} "
                        f"exceeds 1")
                object.__setattr__(self, "sampling_p", p)
        if self.faults is not None:
            from ..faults import FaultSpec  # cycle
            if not isinstance(self.faults, FaultSpec):
                raise TypeError(f"faults must be a repro_torch.faults."
                                f"FaultSpec, got {type(self.faults)}")
            if self.faults.N != self.N:
                raise ValueError(f"FaultSpec describes {self.faults.N} "
                                 f"workers, config has {self.N}")

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
        kind, q = config.codec_kind, config.bucket
        self.worker_codecs = [make_codec(s, bucket=q, backend="cuda",
                                         kind=kind)
                              for s in config.worker_s()]
        self.server_codec = make_codec(config.s0, bucket=q, backend="cuda",
                                       kind=kind)
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
              u_workers: torch.Tensor, u_server: torch.Tensor, gamma,
              u: Optional[torch.Tensor] = None):
        """One global iteration (Algorithm 1, lines 3-10) -> (x̂_new flat,
        metrics of device scalars).

        ``u`` (length N, float32 on the run's device; only under client
        sampling or faults) replaces the server aggregation with the
        Horvitz-Thompson weighted sum ``Σ_n u_n Q(Δ_n)``: ``u_n = 0``
        drops a worker outside the round's delivered cohort and the rest
        are reweighted so the round is an unbiased estimate of the full
        one."""
        g = float(np.float32(gamma))     # the step size as the f32 it is
        deltas = self._upload(self.worker_deltas(x_hat_flat, idx, g),
                              u_workers)
        if u is not None:                # sampled round: reweighted cohort
            delta_hat = torch.tensordot(u, deltas, dims=1)
        elif self._agg is None:
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
        its mini-batch indices and quantizer noise from ``generator``.

        Under client sampling (``cfg.sampling_S``) each round draws a
        cohort from ``np.random.default_rng(cfg.seed)`` and aggregates it
        with unbiased Horvitz-Thompson weights; ``self.cohort_trace``
        records the drawn cohort indices per round.  Under fault injection
        (``cfg.faults``) each round also draws faults from the separate
        ``fault_rng(cfg.seed)`` stream (so the cohort sequence is unchanged
        by the fault model), excludes crashed / timed-out / corrupted
        workers and divides the survivors' weights by their delivery
        probabilities; ``self.fault_trace`` is the run's
        :class:`~repro_torch.faults.FaultTrace`.  Unsampled, unfaulted
        configs take the plain mean (or ``agg_weights``) path.
        """
        from ..sampling.base import cohort_weights, draw_cohort  # cycle
        cfg = self.cfg
        gammas = cfg.step_rule.sequence(cfg.K0)
        N, M = cfg.N, self.msg_dim
        x = x0_flat
        history = []
        self.cohort_trace = []
        self.fault_trace = None
        rng = (np.random.default_rng(cfg.seed)
               if cfg.sampling_S is not None else None)
        fdrv = None
        if cfg.faults is not None:
            from ..faults import FaultDriver, fault_rng  # cycle
            fdrv = FaultDriver(cfg.faults, N, cfg.agg_weights)
            frng = fault_rng(cfg.seed)
        # round metrics (repro_torch.obs): priced from the static config
        # and the host-side cohort/fault records only, so the round itself
        # is untouched and a disabled run pays one boolean check a round
        obs_on = _OBS_ON.on
        if obs_on:
            up_bits = [c.wire_bits(self.dim) for c in self.worker_codecs]
            down_bits = self.server_codec.wire_bits(self.dim)
            round_h = _METRICS.histogram("run.round_s", backend="reference")
            htvar_h = _METRICS.histogram("run.ht_weight_var",
                                         backend="reference")
            bits_c = _METRICS.counter("run.wire_bits", backend="reference",
                                      codec=cfg.codec_kind)
            rounds_c = _METRICS.counter("run.rounds", backend="reference")
        for k0 in range(cfg.K0):
            t0 = time.perf_counter() if obs_on else 0.0
            idx = sample_indices(generator, self.n_local, N, cfg.K_max,
                                 cfg.B)
            u_w = torch.rand((N, M), generator=generator, device=self.device)
            u_s = torch.rand((M,), generator=generator, device=self.device)
            cohort = pi = u = None
            if rng is not None:
                cohort, pi = draw_cohort(rng, N, cfg.sampling_S,
                                         cfg.sampling_p)
                self.cohort_trace.append(cohort)
            if fdrv is not None:
                u = fdrv.step(frng, k0, cohort, pi)
            elif cohort is not None:    # sampling only: the plain HT path
                u = cohort_weights(cohort, pi, N, cfg.agg_weights)
            u_t = None if u is None else torch.as_tensor(
                u, dtype=torch.float32, device=self.device)
            x, m = self.round(x, idx, u_w, u_s, gammas[k0], u_t)
            if obs_on:
                # launches are asynchronous: this is the host loop's time
                # a round (exact where an eval forces a sync), never an
                # added synchronize — observing must not serialize
                round_h.observe(time.perf_counter() - t0)
                rounds_c.inc()
                if u is not None:
                    # plain-python variance: np.var costs ~15us of ufunc
                    # dispatch for a length-N vector
                    ul = u.tolist()
                    mu = sum(ul) / len(ul)
                    htvar_h.observe(sum((v - mu) ** 2 for v in ul) / len(ul))
                if fdrv is not None:
                    rec = fdrv.last   # crashed workers never reach the wire
                    senders = (rec.cohort if not rec.crashed
                               else set(rec.cohort) - set(rec.crashed))
                elif cohort is not None:
                    senders = set(int(i) for i in cohort)
                else:
                    senders = range(N)
                bits_c.inc(sum(up_bits[i] for i in senders) + down_bits)
            if eval_fn is not None and (k0 % eval_every == 0
                                        or k0 == cfg.K0 - 1):
                e = eval_fn(x)
                e.update({k: float(v) for k, v in m.items()})
                e["k0"] = k0
                history.append(e)
        if fdrv is not None:
            self.fault_trace = fdrv.trace()
        return x, history


def _lead(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-worker (N,) tensor shaped to broadcast against ``like``."""
    return t.view(-1, *([1] * (like.dim() - 1)))
