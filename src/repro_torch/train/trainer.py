"""GenQSGD trainer for the federated LM runtime (``repro/train/trainer.py``):
the driver that strings rounds together.

Runs the round of :mod:`repro_torch.fed.runtime` (all fl workers on one
card with the default transport, or one a rank) with a step-size sequence
from :mod:`repro_torch.core.step_rules`.  Cohorts and faults are drawn on
the host from the JAX package's NumPy streams (``default_rng(fed.seed)``,
``fault_rng(fed.seed)``), so their traces equal the JAX package's for a
seed.  Each round's workers' and server's key words come from a
``default_rng(seed)`` stream of uint32 pairs, where the JAX package splits
a ``jax.random`` key.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..core.step_rules import StepRule
from ..fed.runtime import FedConfig, make_round_fn, tree_leaves
from ..obs import REGISTRY as _METRICS
from ..obs.metrics import GLOBAL_SWITCH as _OBS_ON
from . import checkpoint as CKPT


def round_comm_bits(fed: FedConfig, dim: int, cohort=None) -> float:
    """Wire bits one round moves: worker uploads + the server multicast,
    priced by the same codec table the cost-layer optimizer uses.

    ``cohort`` (an index array, only under client sampling) restricts the
    upload sum to the workers that actually participated this round."""
    codecs = fed.codecs()
    idx = range(fed.n_workers) if cohort is None else cohort
    up = sum(codecs[int(i)].wire_bits(dim) for i in idx)
    return up + fed.server_codec().wire_bits(dim)


__all__ = ["TrainState", "GenQSGDTrainer", "round_comm_bits"]


@dataclasses.dataclass
class TrainState:
    params: object
    round: int
    history: list


def round_keys(rng: np.random.Generator, n_workers: int) -> np.ndarray:
    """One round's key words: (fl + 1, 2) uint32, the workers' rows then
    the server's."""
    return rng.integers(0, 1 << 32, size=(n_workers + 1, 2),
                        dtype=np.uint64).astype(np.uint32)


class GenQSGDTrainer:
    """``GenQSGDTrainer(api, cfg, fed, transport, step_rule,
    checkpoint_dir, device)``: ``api`` is a model module (``init_params``,
    ``loss_train``), ``transport`` None for every fl worker in this process,
    ``device`` the card unless the caller asks for the CPU."""

    def __init__(self, api, cfg: ArchConfig, fed: FedConfig, transport=None,
                 step_rule: StepRule = None,
                 checkpoint_dir: Optional[str] = None, device="cuda"):
        self.api = api
        self.cfg = cfg
        self.fed = fed
        self.rule = step_rule
        self.ckpt_dir = checkpoint_dir
        self.device = resolve_device(device)
        self._round = make_round_fn(api, cfg, fed, transport)

    def init(self, seed: int = 0, dtype=torch.float32) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        params = self.api.init_params(self.cfg, gen, dtype=dtype)
        return TrainState(params=params, round=0, history=[])

    def run(self, state: TrainState, batches: Iterator, seed: int,
            n_rounds: int, log_every: int = 10,
            eval_fn: Optional[Callable] = None,
            ckpt_every: int = 0) -> TrainState:
        """``n_rounds`` rounds from ``state``; ``seed`` seeds the rounds'
        key words.  Every ``log_every`` rounds (and the last) a history
        record is kept and printed; ``eval_fn(params)`` adds to it."""
        gammas = self.rule.sequence(state.round + n_rounds)
        dim = sum(int(l.numel()) for l in tree_leaves(state.params))
        comm_mbits = round_comm_bits(self.fed, dim) / 1e6
        fed = self.fed
        keys = np.random.default_rng(seed)
        rng = (np.random.default_rng(fed.seed)
               if fed.sampling_S is not None else None)
        self.cohort_trace = []
        self.fault_trace = None
        fdrv = None
        if fed.faults is not None:
            # same driver + rng construction as the reference runtime, so a
            # (seed, model) pair produces the bit-identical FaultTrace on
            # either backend
            from ..faults import FaultDriver, fault_rng  # cycle
            fdrv = FaultDriver(fed.faults, fed.n_workers, fed.agg_weights)
            frng = fault_rng(fed.seed)
        # round metrics (repro_torch.obs): reads only host-side values the
        # loop already computes; disabled runs pay one boolean check a round
        obs_on = _OBS_ON.on
        if obs_on:
            _round_h = _METRICS.histogram("run.round_s", backend="spmd")
            _htvar_h = _METRICS.histogram("run.ht_weight_var", backend="spmd")
            _bits_c = _METRICS.counter("run.wire_bits", backend="spmd",
                                       codec=fed.wire)
            _rounds_c = _METRICS.counter("run.rounds", backend="spmd")
        for r in range(state.round, state.round + n_rounds):
            words = round_keys(keys, fed.n_workers)
            batch = next(batches)
            t0 = time.time()
            idx = pi = u = None
            if rng is not None:
                from ..sampling.base import cohort_weights, draw_cohort
                idx, pi = draw_cohort(rng, fed.n_workers, fed.sampling_S,
                                      fed.sampling_p)
                self.cohort_trace.append(idx)
            if fdrv is not None:
                u = fdrv.step(frng, r, idx, pi)
                # crashed workers never upload; timed-out/corrupt ones do
                # (the server just discards them), so they still pay bits
                rec = fdrv.last
                uploaded = [i for i in rec.cohort if i not in rec.crashed]
                comm_mbits = round_comm_bits(fed, dim, cohort=uploaded) / 1e6
            elif idx is not None:   # sampling only: the historical HT path
                u = cohort_weights(idx, pi, fed.n_workers, fed.agg_weights)
                comm_mbits = round_comm_bits(fed, dim, cohort=idx) / 1e6
            state.params, metrics = self._round(
                state.params, batch, words[:-1], words[-1],
                np.float32(gammas[r]),
                None if u is None else np.asarray(u, np.float32))
            if obs_on:
                # launches are asynchronous: host loop time per round, never
                # an added synchronize (observing must not serialize)
                _round_h.observe(time.time() - t0)
                _rounds_c.inc()
                _bits_c.inc(comm_mbits * 1e6)
                if u is not None:
                    # plain-python variance (see genqsgd.run): keeps the
                    # per-round observability cost off the ufunc path
                    _ul = u.tolist()
                    _mu = sum(_ul) / len(_ul)
                    _htvar_h.observe(
                        sum((v - _mu) ** 2 for v in _ul) / len(_ul))
            if r % log_every == 0 or r == state.round + n_rounds - 1:
                rec = {"round": r, "gamma": float(gammas[r]),
                       "loss": float(metrics["loss"]),
                       "delta_norm": float(metrics["delta_norm"]),
                       "comm_mbits": comm_mbits,
                       "dt": time.time() - t0}
                if eval_fn is not None:
                    rec.update(eval_fn(state.params))
                state.history.append(rec)
                print("  " + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                                      else f"{k}={v}" for k, v in rec.items()),
                      flush=True)
            if self.ckpt_dir and ckpt_every and (r + 1) % ckpt_every == 0:
                CKPT.save(f"{self.ckpt_dir}/round_{r+1:06d}.ckpt",
                          state.params, {"round": r + 1})
            state.round = r + 1
        if fdrv is not None:
            self.fault_trace = fdrv.trace()
        return state
