"""Mixture-of-Experts MLP (``repro/models/moe.py``): top-k routing with
capacity and a scatter dispatch, in PyTorch.

Dispatch fills an (E, C, D) expert buffer (no (T, E, C) one-hot dispatch
tensor), the expert products are batched matrix products over E, and the
combine gathers each assignment's row back.  Token-dropping semantics are
the reference's: an assignment beyond its expert's capacity
``C = ceil(T * top_k / E * capacity_factor)`` is dropped (it contributes
zero and the residual stream passes through); a slot's position is the
token-major running count of its expert's assignments.

The reference fills the buffer by a scatter-add whose dropped assignments
add zeros at slot C - 1.  The kept assignments' targets are distinct, so
here each is copied to its own row and the dropped ones to one spare row
that is then cut away: the buffer is the same and the copy is
deterministic on the card.  ``jax.lax.top_k`` breaks ties toward the lower
expert index; a stable descending sort does the same here
(``torch.topk`` promises no order among equals).

With the expert axis sharded over ``tp`` the reference lets GSPMD insert
the all-to-all; the port runs one card a worker and has no counterpart.

Under a running ``torch.profiler`` the four stages are the ranges
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(:func:`repro_torch.obs.trace.device_range`); :func:`recording_routes`
collects the routings.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..obs.trace import device_range
from .blocks import dense_init

__all__ = ["moe_init", "moe_apply", "router_aux_loss", "route", "dispatch",
           "experts", "combine", "recording_routes"]

#: the lists of the :func:`recording_routes` contexts open now
_ROUTE_SINKS: list = []


@contextlib.contextmanager
def recording_routes():
    """While inside, every :func:`moe_apply` appends its routing ``top_i``
    (T, k), detached and on its device, to the list this yields."""
    sink: list = []
    _ROUTE_SINKS.append(sink)
    try:
        yield sink
    finally:
        _ROUTE_SINKS.remove(sink)


def moe_init(generator, cfg: ArchConfig, dtype=torch.float32,
             lead: tuple = ()):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_expert
    dev = generator.device

    def normal(*shape, scale):
        return torch.randn(*lead, *shape, generator=generator,
                           device=dev).mul_(scale).to(dtype)
    return {
        "router": dense_init(generator, D, E, dtype, lead),
        "w_gate": normal(E, D, Fd, scale=1.0 / math.sqrt(D)),
        "w_up": normal(E, D, Fd, scale=1.0 / math.sqrt(D)),
        "w_down": normal(E, Fd, D, scale=1.0 / math.sqrt(Fd)),
    }


def route(p, xf, cfg: ArchConfig):
    """The router of tokens xf (T, D): -> (probs (T, E) f32, top_p (T, k)
    renormalized, top_i (T, k), keep (T*k,) bool, slot (T*k,), C).

    Softmax in f32, the k largest per token (ties to the lower index),
    then each assignment's position in its expert by a token-major running
    count; ``keep`` is position < C."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = (xf @ p["router"]).to(torch.float32)            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = vals[:, :k], idx[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    C = int(math.ceil(T * k / E * cfg.capacity_factor))
    flat_e = top_i.reshape(-1)                                # (T*k,)
    onehot = F.one_hot(flat_e, E)                             # (T*k, E)
    pos = torch.gather(onehot.cumsum(0) - 1, 1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, pos, C - 1)
    return probs, top_p, top_i, keep, slot, C


def dispatch(xf, flat_e, keep, slot, E: int, C: int):
    """The (E, C, D) expert buffer of tokens xf (T, D): kept assignment i
    (token i // k) at [flat_e[i], slot[i]], the rest zeros."""
    T, D = xf.shape
    k = flat_e.shape[0] // T
    # kept assignment -> row e * C + slot, dropped -> the spare row
    row = torch.where(keep, flat_e * C + slot, E * C)
    tok = torch.arange(T, device=xf.device).repeat_interleave(k)
    buf = xf.new_zeros(E * C + 1, D).index_copy(0, row, xf[tok])
    return buf[:E * C].reshape(E, C, D)


def experts(p, buf):
    """The gated MLP of every expert on its rows: (E, C, D) -> (E, C, D),
    batched products over E."""
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def combine(y_buf, flat_e, slot, top_p, keep):
    """Each token's output: its assignments' rows of y_buf weighted by the
    renormalized router probabilities (0 where dropped), summed over k."""
    T, k = top_p.shape
    gathered = y_buf[flat_e, slot]                            # (T*k, D)
    w = (top_p.reshape(-1) * keep.to(torch.float32)).to(y_buf.dtype)
    return (gathered * w[:, None]).reshape(T, k, -1).sum(dim=1)


def moe_apply(p, x, cfg: ArchConfig):
    """x: (B, S, D) -> (y, router_probs) with y: (B, S, D)."""
    Bt, S, D = x.shape
    xf = x.reshape(Bt * S, D)
    with device_range("moe.route"):
        probs, top_p, top_i, keep, slot, C = route(p, xf, cfg)
    for sink in _ROUTE_SINKS:
        sink.append(top_i.detach())
    flat_e = top_i.reshape(-1)
    with device_range("moe.dispatch"):
        buf = dispatch(xf, flat_e, keep, slot, cfg.n_experts, C)
    with device_range("moe.experts"):
        y_buf = experts(p, buf)
    with device_range("moe.combine"):
        out = combine(y_buf, flat_e, slot, top_p, keep)
    return out.reshape(Bt, S, D), probs


def router_aux_loss(probs: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: E * sum_e f_e * P_e,
    with f_e the fraction of tokens whose argmax is e and P_e the mean
    router probability."""
    E = probs.shape[-1]
    hard = F.one_hot(torch.argmax(probs, dim=-1), E).to(torch.float32)
    f = hard.mean(dim=0)
    P = probs.mean(dim=0)
    return E * torch.sum(f * P)
