"""The federated GenQSGD runtime for LM training (``repro/fed/runtime.py``):
Algorithm 1's round over fl workers, with quantized uploads and a quantized
server multicast.

One *round* (the body of Algorithm 1's global iteration):
  1. every fl worker starts from the shared global model x̂ and runs
     K_max local mini-batch SGD steps (:func:`local_train`; workers with
     K_n < K_max do the paper's masked "virtual" steps, eqs. (6)-(8), which
     are computed and multiplied by 0, as in the reference);
  2. each worker encodes its normalized delta (x_n - x̂)/γ per tensor (or per
     bucket of ``FedConfig.bucket`` coordinates) with its s_n — K1 then K2
     on the card (:func:`~repro_torch.compress.encode_tensor`,
     ``backend="cuda"``);
  3. the encoded uploads travel over ``FedConfig.wire`` through a transport
     (:mod:`repro_torch.fed.transport`) and are aggregated (5);
  4. the server re-quantizes the aggregate with s_0 and every node applies
     it (3) — K3 per tensor, or K3b with buckets (:func:`aggregate_apply`).

The wires (``compress.RUNTIME_WIRES``) are the reference's:

  "f32"   quantized *values* travel as f32 (a sum over fl);
  "int8"  the int8 levels and the norms are gathered, then each worker's
          delta is decoded and aggregated where it is needed;
  "int4"  the same with two levels packed a byte (``wire.pack_int4``,
          s <= 7);
  "rs_ag" each worker decodes its own delta and the aggregate is a
          reduce-scatter (each worker sums its 1/fl shard) then an
          all-gather; a leaf fl does not divide is summed whole;
  "elias" each worker's levels over the whole flattened delta are one
          Elias-omega stream (and the server's multicast one more),
          decoded by the ``elias_decode`` kernel on the card; the realized
          stream bits land in ``metrics["elias_bits"]``.

Levels are exact integers on every wire and every wire aggregates in the
same order (each worker's decoded delta scaled by 1/fl, w_n or u_n, then
summed in worker order), so within this package every wire gives the f32
wire's bits.  Against the reference the server's apply differs by an ulp:
K3 computes x̂ + (γ·lvl)·(‖·‖/s) where the reference computes
x̂ + γ·(lvl·(‖·‖/s)).

Leaves are taken in the reference's ``jax.tree.leaves`` order — dict keys
sorted, recursively (:func:`tree_leaves`) — which fixes the noise seed
salts (``i`` for worker uploads, ``1000 + i`` for the server), the Elias
concatenation and the sum under ``normalize``.  The noise is the
reference's counter hash (:func:`uniform_like`, bit-identical over uint32),
seeded per leaf by :func:`_seed_from` from a key's uint32 words: a round
takes its workers' and server's key words as inputs, so the reference's
``jax.random`` keys can be injected.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..compress import (RUNTIME_WIRES, decode_tensor, elias, encode_tensor,
                        make_codec, pack_int4, unpack_int4, wire_max_s)
from ..compress.backends import decode_apply_bucketed_cuda, decode_apply_cuda
from ..compress.rotation import _mix32, _mulmod32
from ..configs.base import ArchConfig
from .transport import LocalTransport, fold

__all__ = ["FedConfig", "make_round_fn", "local_train", "aggregate_apply",
           "uniform_like", "tree_leaves", "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Static GenQSGD runtime parameters for one training job."""
    n_workers: int                       # fl axis size
    Kn: tuple                            # per-worker local steps (len == fl)
    s0: Optional[int]                    # server quantizer (None = exact)
    sn: object = None                    # worker quantizer: int (homogeneous),
                                         # tuple of per-worker ints, or None
    wire: str = "f32"                    # one of compress.RUNTIME_WIRES
    bucket: object = None                # per-bucket-norm quantization: bucket
                                         # size (EdgeSystem's q_dim), or None
    aux_weight: float = 0.01
    microbatch: int = 1                  # grad-accumulation splits per local step
    agg_weights: object = None           # per-worker aggregation weights w_n
                                         # (tuple, len fl; None = plain mean)
    momentum: float = 0.0                # local-update momentum beta
    normalize: bool = False              # normalized local updates (GQFedWAvg)
    sampling_S: object = None            # per-round cohort size (None = full)
    sampling_p: object = None            # per-worker base probabilities
                                         # (tuple, len fl; None = uniform)
    seed: object = None                  # cohort/fault rng seed (trainer side)
    faults: object = None                # repro_torch.faults.FaultSpec (None =
                                         # no faults)

    def __post_init__(self):
        if self.wire not in RUNTIME_WIRES:
            raise ValueError(f"wire must be one of {RUNTIME_WIRES}, "
                             f"got {self.wire!r}")
        from ..families import check_agg_weights, check_momentum  # cycle
        if self.agg_weights is not None:
            object.__setattr__(self, "agg_weights",
                               check_agg_weights(self.agg_weights,
                                                 self.n_workers))
        check_momentum(self.momentum)
        if self.sampling_p is not None and self.sampling_S is None:
            raise ValueError("sampling_p given without sampling_S")
        if self.sampling_S is not None:
            from ..sampling.base import check_probs  # cycle
            S = int(self.sampling_S)
            if not 1 <= S <= self.n_workers:
                raise ValueError(
                    f"sampling_S={S} outside [1, N={self.n_workers}]")
            object.__setattr__(self, "sampling_S", S)
            if self.sampling_p is not None:
                p = check_probs(self.sampling_p, self.n_workers)
                if S * max(p) > 1.0 + 1e-9:
                    raise ValueError(
                        f"inclusion probability S*max(p)={S * max(p):.4g} "
                        f"exceeds 1")
                object.__setattr__(self, "sampling_p", p)
            # the per-round HT weight vector u is a round input, so sampling
            # needs an aggregation that takes it: the f32 transport, or the
            # bucketed level wires (whose decode + combine run where the
            # gathered levels are)
            if not (self.wire == "f32"
                    or (self.bucket is not None
                        and self.wire in ("int8", "int4"))):
                raise ValueError(
                    f"client sampling is not supported on wire="
                    f"{self.wire!r}" + ("" if self.bucket is not None
                                        else " without bucketing")
                    + "; use wire='f32' or a bucketed int8/int4 wire")
        if self.faults is not None:
            from ..faults import FaultSpec  # cycle
            if not isinstance(self.faults, FaultSpec):
                raise TypeError(f"faults must be a repro_torch.faults."
                                f"FaultSpec, got {type(self.faults)}")
            if self.faults.N != self.n_workers:
                raise ValueError(f"FaultSpec describes {self.faults.N} "
                                 f"workers, config has {self.n_workers}")
            # deadline-HT aggregation rides the same per-round u vector as
            # client sampling, with the same wire restriction
            if not (self.wire == "f32"
                    or (self.bucket is not None
                        and self.wire in ("int8", "int4"))):
                raise ValueError(
                    f"fault injection is not supported on wire="
                    f"{self.wire!r}" + ("" if self.bucket is not None
                                        else " without bucketing")
                    + "; use wire='f32' or a bucketed int8/int4 wire")
        if self.bucket is not None and int(self.bucket) <= 0:
            raise ValueError(f"bucket must be positive, got {self.bucket}")
        cap = wire_max_s(self.wire)
        if self.wire == "elias":
            # pricing is unbounded in s (cap is None), but the runtime
            # coder reads levels from an int8 container like every other
            # level transport
            cap = elias.MAX_RUNTIME_S
        for s in self.sn_tuple() + (self.s0,):
            if s is not None and cap is not None and s > cap:
                raise ValueError(
                    f"wire {self.wire!r} carries s <= {cap}, got {s}")
        sn = self.sn_tuple()
        if not self.sn_exact and any(s is None for s in sn):
            # the level transports carry every worker's delta in the same
            # integer container, which cannot represent an exact passthrough
            raise ValueError("mixed exact (s=None) and quantized workers are "
                             "not supported: set s_n for every worker, or "
                             "None for all")
        if self.wire == "int4" and self.sn_exact:
            raise ValueError("int4 wire packs quantized levels; exact "
                             "(s=None) workers need the f32 or rs_ag wire")

    @property
    def K_max(self) -> int:
        return int(max(self.Kn))

    def sn_tuple(self) -> tuple:
        """Per-worker quantization parameters (heterogeneous allowed)."""
        if isinstance(self.sn, (tuple, list)):
            assert len(self.sn) == self.n_workers
            return tuple(self.sn)
        return (self.sn,) * self.n_workers

    @property
    def sn_exact(self) -> bool:
        return all(s is None for s in self.sn_tuple())

    def codecs(self) -> tuple:
        """Per-worker codec views (cost accounting / introspection)."""
        return tuple(make_codec(s, wire=self.wire, bucket=self.bucket)
                     for s in self.sn_tuple())

    def server_codec(self):
        """An exact server multicast (s0=None) is raw f32 regardless of the
        worker wire — the packing wire can't carry it, but the runtime never
        packs the server update anyway."""
        wire = self.wire if self.s0 is not None else "f32"
        return make_codec(self.s0, wire=wire, bucket=self.bucket)


# ---------------------------------------------------------------------------
# parameter trees in the reference's leaf order
# ---------------------------------------------------------------------------
def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list tree in ``jax.tree.leaves`` order:
    dict keys sorted, lists in order, recursively."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


# ---------------------------------------------------------------------------
# counter-based uniform noise: the reference's murmur3-finalizer hash of the
# flat index, bit-identical over uint32 (int64 tensors masked to 32 bits, the
# multiplies of compress.rotation split so that none overflows)
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
#: coordinates hashed at once: the hash is elementwise over the C-order
#: flat index, so a tensor is generated in pieces of this many (int64
#: temporaries of 256 MB) without changing a bit
_NOISE_CHUNK = 1 << 25


def _mix32_int(z: int) -> int:
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return z ^ (z >> 16)


def uniform_like(x: torch.Tensor, seed: int) -> torch.Tensor:
    """U(0,1) f32 tensor shaped like x on x's device, from a counter hash of
    the flat index and ``seed`` (a uint32 value)."""
    n = x.numel()
    seed = int(seed) & _M32
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    for a in range(0, n, _NOISE_CHUNK):
        z = torch.arange(a, min(n, a + _NOISE_CHUNK), dtype=torch.int64,
                         device=x.device)
        z = (_mulmod32(z, 0x9E3779B9) + seed) & _M32
        z = _mix32((_mix32(z) + 0x27D4EB2F) & _M32)
        out[a:a + z.shape[0]] = (z >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return out.reshape(x.shape)


def _seed_from(words, salt: int) -> int:
    """A leaf's noise seed from a key's uint32 words and a salt (the
    reference's ``_seed_from`` on the key's data)."""
    seed = (int(salt) * 0x9E3779B9) & _M32
    for w in np.asarray(words).reshape(-1).astype(np.uint32).tolist():
        seed = _mix32_int(seed ^ int(w))
    return seed


# ---------------------------------------------------------------------------
# local training (one worker)
# ---------------------------------------------------------------------------
def _loss_grad(api, cfg, fed, like, leaves, batch):
    xs = [w.detach().requires_grad_(True) for w in leaves]
    with torch.enable_grad():
        loss = api.loss_train(tree_unflatten(like, xs), cfg, batch,
                              aux_weight=fed.aux_weight)
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), list(grads)


def _micro(a: torch.Tensor, M: int, m: int, axis: int = 0) -> torch.Tensor:
    """Micro-batch m of M along the batch axis ``axis`` (the whole of a
    leaf that M does not divide, as the reference broadcasts it)."""
    if a.dim() > axis and a.shape[axis] % M == 0:
        k = a.shape[axis] // M
        return a.narrow(axis, m * k, k)
    return a


def _batch_axis(key: str) -> int:
    """The batch axis of a step's batch leaf: 1 for M-RoPE's positions3
    (3, B, S), else 0."""
    return 1 if key == "positions3" else 0


def _eval_grad(api, cfg, fed, like, p, batch):
    """Loss and gradients at the bf16 view of the f32 leaves (the update
    goes to the master copy); ``microbatch`` splits accumulate
    ``g_acc + g / M`` in the gradients' dtype."""
    half = [w.to(torch.bfloat16) if w.dtype == torch.float32 else w
            for w in p]
    M = fed.microbatch
    if M == 1:
        return _loss_grad(api, cfg, fed, like, half, batch)
    g_acc = [torch.zeros_like(w) for w in half]
    l_acc = torch.zeros((), dtype=torch.float32, device=half[0].device)
    for m in range(M):
        micro = {k: _micro(v, M, m, _batch_axis(k))
                 for k, v in batch.items()}
        l, g = _loss_grad(api, cfg, fed, like, half, micro)
        g_acc = [a + gg.to(a.dtype) / M for a, gg in zip(g_acc, g)]
        l_acc = l_acc + l / M
    return l_acc, g_acc


def local_train(api, cfg: ArchConfig, fed: FedConfig, x_hat, batch, kn: int,
                gamma):
    """One worker's K_max local steps from x̂ -> (params, mean loss over
    the steps).

    ``batch`` holds this worker's leaves shaped (K_max, B, ...); ``kn`` its
    active steps (later steps are virtual: computed, then moved by 0).  The
    update is ``(w.f32 - (γ·active)·g.f32).to(w.dtype)``; with
    ``momentum``/``normalize`` (GQFedWAvg) an active step updates
    ``v <- β v + (1 - β) g`` (as ``v + active·(β v + (1 - β) g - v)``) and
    moves along v, unit-normalized over the whole model under
    ``normalize``."""
    p = tree_leaves(x_hat)
    dev = p[0].device
    f32 = torch.float32
    g_t = torch.tensor(np.float32(gamma), dtype=f32, device=dev)
    use_momentum = fed.momentum > 0.0 or fed.normalize
    if use_momentum:
        beta = torch.tensor(fed.momentum, dtype=f32, device=dev)
        one_minus_beta = torch.ones_like(beta) - beta
        v = [torch.zeros(w.shape, dtype=f32, device=dev) for w in p]
    batch = {k: torch.as_tensor(t).to(dev) for k, t in batch.items()}
    losses = []
    for step in range(fed.K_max):
        loss, g = _eval_grad(api, cfg, fed, x_hat, p,
                             {k: t[step] for k, t in batch.items()})
        losses.append(loss)
        active = torch.tensor(1.0 if step < kn else 0.0, dtype=f32,
                              device=dev)
        if use_momentum:
            for i, gg in enumerate(g):
                v[i] = v[i] + active * (beta * v[i] + one_minus_beta
                                        * gg.to(f32) - v[i])
                g[i] = None
            scale = g_t * active
            if fed.normalize:
                vn = torch.sqrt(sum(torch.sum(torch.square(vv))
                                    for vv in v))
                scale = scale / torch.clamp_min(vn, 1e-12)
            for i, vv in enumerate(v):
                p[i] = (p[i].to(f32) - scale * vv).to(p[i].dtype)
        else:
            scale = g_t * active
            for i, gg in enumerate(g):
                p[i] = (p[i].to(f32) - scale * gg.to(f32)).to(p[i].dtype)
                g[i] = None
    return tree_unflatten(x_hat, p), torch.stack(losses).mean()


# ---------------------------------------------------------------------------
# aggregation and the server's apply
# ---------------------------------------------------------------------------
def _weights(fed: FedConfig, u, dev):
    """How worker n's decoded delta d enters the aggregate: -> f(n, d).
    Under ``u`` (sampling / faults) the round's Horvitz-Thompson weight,
    else ``fed.agg_weights`` normalized, else 1/fl (a true division)."""
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32).to(dev)
        return lambda n, d: d * u[n]
    if fed.agg_weights is None:
        fl = torch.tensor(float(fed.n_workers), dtype=torch.float32,
                          device=dev)
        return lambda n, d: d / fl
    w = np.asarray(fed.agg_weights, np.float64)
    w = torch.tensor(w / w.sum(), dtype=torch.float32, device=dev)
    return lambda n, d: d * w[n]


def _encode_workers(fed: FedConfig, transport, deltas, wseeds, i):
    """The local workers' uploads of leaf i: deltas (k, n) f32 -> (levels
    (k, n) int8, norms (k,) or (k, n_buckets)) by K1 then K2 (one launch
    each over the k rows when the workers share s); exact workers pass
    their f32 delta through with no norm."""
    if fed.sn_exact:
        return deltas, None
    bucket = None if fed.bucket is None else int(fed.bucket)
    ss = [fed.sn_tuple()[w] for w in transport.workers]
    us = torch.empty_like(deltas)
    for j, w in enumerate(transport.workers):
        us[j] = uniform_like(deltas[j], _seed_from(wseeds[w], i))
    if len(set(ss)) == 1:
        return encode_tensor(deltas, ss[0], us, backend="cuda",
                             bucket=bucket)
    out = [encode_tensor(deltas[j], s, us[j], backend="cuda",
                         bucket=bucket) for j, s in enumerate(ss)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def _elias_roundtrip(transport, levels):
    """Each local worker's levels over the whole flattened delta as one
    Elias-omega stream; the streams gathered and decoded (``elias_decode``
    on the card) -> (per-leaf (fl, n) int8 levels, total stream bits)."""
    flat = torch.cat(levels, dim=1).to(torch.int8)
    words, nb = elias.encode_levels(flat)
    dec = elias.decode_levels(transport.gather(list(words)), flat.shape[1])
    bits = transport.gather(list(nb)).sum()
    out, off = [], 0
    for lv in levels:
        out.append(dec[:, off:off + lv.shape[1]])
        off += lv.shape[1]
    return out, bits


def aggregate_apply(fed: FedConfig, transport, x_hat, params_w, wseeds,
                    sseeds, gamma, u=None):
    """Aggregate the local workers' trained params over ``fed.wire`` and
    apply the server's quantized update -> (x̂', metrics ``delta_norm``
    [, ``elias_bits``]), leaf by leaf.

    ``params_w`` holds one trained tree per worker of ``transport.workers``;
    ``wseeds`` (fl, W) and ``sseeds`` (W,) are the workers' and the server's
    key words (uint32); ``u`` (fl,) the round's Horvitz-Thompson weights
    (sampling / faults; read on the wires that take it, as the reference),
    else the mean or ``fed.agg_weights``."""
    xs = tree_leaves(x_hat)
    wl = [tree_leaves(p) for p in params_w]
    if len(wl) != len(transport.workers):
        raise ValueError(f"{len(wl)} trained trees for "
                         f"{len(transport.workers)} local workers")
    dev, f32 = xs[0].device, torch.float32
    fl, wire, sn = fed.n_workers, fed.wire, fed.sn_tuple()
    bucket = None if fed.bucket is None else int(fed.bucket)
    gf = float(np.float32(gamma))
    g_t = torch.tensor(gf, dtype=f32, device=dev)
    takes_u = wire in ("f32", "elias") or (bucket is not None
                                           and wire in ("int8", "int4"))
    weigh = _weights(fed, u if takes_u else None, dev)

    def upload(i):
        d = torch.stack([(w[i].to(f32) - xs[i].to(f32)).reshape(-1)
                         for w in wl])
        return _encode_workers(fed, transport, d.div_(g_t), wseeds, i)

    def decoded(lvl, nrm, ids):
        """Each listed worker's delta, decoded and weighted."""
        return [weigh(w, decode_tensor(lvl[r], None if nrm is None
                                       else nrm[r], sn[w], bucket=bucket))
                for r, w in enumerate(ids)]

    elias_bits = None
    if wire == "elias" and not fed.sn_exact:
        enc = [upload(i) for i in range(len(xs))]
        lv_fl, elias_bits = _elias_roundtrip(transport, [e[0] for e in enc])
        nrm_fl = [transport.gather(list(e[1])) for e in enc]
        del enc
    server, sq = [], []
    for i in range(len(xs)):
        if elias_bits is not None:       # gathered by the elias streams
            dh = fold(decoded(lv_fl[i], nrm_fl[i], range(fl)))
            lv_fl[i] = nrm_fl[i] = None
        else:
            lvl, nrm = upload(i)
            n = lvl.shape[-1]
            if wire in ("f32", "elias"):     # f32 values summed over fl
                dh = transport.sum(decoded(lvl, nrm, transport.workers))
            elif wire in ("int8", "int4"):   # payload gathered, decoded here
                pay = pack_int4(lvl) if wire == "int4" else lvl
                g = transport.gather(list(pay))
                if wire == "int4":
                    g = unpack_int4(g, n)
                dh = fold(decoded(g, None if nrm is None
                                   else transport.gather(list(nrm)),
                                   range(fl)))
            else:                            # rs_ag
                parts = decoded(lvl, nrm, transport.workers)
                if n % fl:                   # ragged leaf: the whole sum
                    dh = transport.sum(parts)
                else:
                    own = transport.reduce_scatter(
                        [p.reshape(fl, -1) for p in parts])
                    dh = transport.gather(own).reshape(n)
            del lvl, nrm
        sq.append(torch.sum(torch.square(dh)))
        u0 = uniform_like(dh, _seed_from(sseeds, 1000 + i))
        server.append(encode_tensor(dh, fed.s0, u0, backend="cuda",
                                    bucket=bucket))
        del dh, u0
    metrics = {"delta_norm": torch.sqrt(sum(sq))}
    if wire == "elias" and fed.s0 is not None:
        # the server multicast rides the same coder: one stream over the
        # whole flattened update
        flat = torch.cat([lv for lv, _ in server])
        words, nb = elias.encode_levels(flat[None])
        dec = elias.decode_levels(words, flat.shape[0])[0]
        off = 0
        for j, (lv, nrm) in enumerate(server):
            server[j] = (dec[off:off + lv.shape[0]], nrm)
            off += lv.shape[0]
        elias_bits = nb.sum() if elias_bits is None \
            else elias_bits + nb.sum()
    if elias_bits is not None:
        metrics["elias_bits"] = elias_bits
    new = []
    for x, (lv, nrm) in zip(xs, server):
        xf = x.to(f32).reshape(-1)
        if fed.s0 is None:
            out = xf + g_t * lv
        elif bucket is None:             # K3
            out = decode_apply_cuda(xf, lv.contiguous(), nrm.reshape(1),
                                    fed.s0, gf)
        else:                            # K3b
            out = decode_apply_bucketed_cuda(xf, lv.contiguous(), nrm,
                                             fed.s0, gf, bucket)
        new.append(out.reshape(x.shape).to(x.dtype))
    return tree_unflatten(x_hat, new), metrics


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------
def make_round_fn(api, cfg: ArchConfig, fed: FedConfig, transport=None):
    """Build ``round(x_hat, batch, wseeds, sseeds, gamma, u=None) ->
    (x_hat', metrics)``, a pure function of its inputs.

    ``batch`` leaves are (fl, K_max, B, ...) (each process reads its own
    workers' rows); ``wseeds`` (fl, W) / ``sseeds`` (W,) the workers' and
    the server's key words.  ``transport`` defaults to all fl workers in
    this process (:class:`~repro_torch.fed.transport.LocalTransport`).

    The reference's ``mesh``, ``fsdp_weights`` and ``moe_tp_only`` only
    choose a GSPMD layout for the params and gradients (the expert axis
    over ``tp`` for MoE); a worker here runs on one card, so they have no
    counterpart, as ``repro/models/shardctx.py`` has none.  MoE and hybrid
    models train through the same round: ``loss_train`` adds the routers'
    aux loss at ``fed.aux_weight``."""
    transport = LocalTransport(fed.n_workers) if transport is None \
        else transport
    if transport.n_workers != fed.n_workers:
        raise ValueError(f"the transport carries {transport.n_workers} "
                         f"workers, the config {fed.n_workers}")

    def genqsgd_round(x_hat, batch, wseeds, sseeds, gamma, u=None):
        trained, losses = [], []
        for w in transport.workers:
            p, loss = local_train(api, cfg, fed, x_hat,
                                  {k: v[w] for k, v in batch.items()},
                                  fed.Kn[w], gamma)
            trained.append(p)
            losses.append(loss)
        x_new, metrics = aggregate_apply(fed, transport, x_hat, trained,
                                         wseeds, sseeds, gamma, u)
        metrics["loss"] = transport.gather(losses).mean()
        return x_new, metrics

    return genqsgd_round
