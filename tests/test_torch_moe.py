"""The MoE MLP of repro_torch (``models/moe.py``) against the JAX package's
(``repro/models/moe.py``) on the CPU, at the smoke configs of olmoe-1b-7b
(4 experts top-2, capacity factor 1.25) and phi3.5-moe (capacity factor
1.0, so some experts overflow and drop assignments).

Weights are the JAX package's ``moe_init`` carried across; inputs come from
numpy seeds.  Tolerances:
- routing (``top_i``, ``keep``, ``slot``) equal, and no tie at the top-k
  boundary of any token (a tie would make the comparison depend on the
  tie rule; the test fails loudly instead of loosening);
- the router probabilities within 1e-6, y within 1e-5 (the same f32
  algebra in another order; the combine sums over k in another order);
- ``router_aux_loss`` within 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RMOE
from repro.models.registry import get_config as r_get_config
from repro_torch.models import moe as PMOE
from repro_torch.models.registry import get_config

ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
#: (B, S): tokens T = B * S from 1 (C = 1) to 128
SHAPES = ((1, 1), (2, 5), (1, 64), (2, 64))


#: the reference's forward and its aux loss, compiled once a shape
_R_APPLY = jax.jit(RMOE.moe_apply, static_argnums=2)
_R_AUX = jax.jit(RMOE.router_aux_loss)


def _params(arch, seed=0):
    rcfg = r_get_config(arch, smoke=True)
    rp = jax.jit(RMOE.moe_init, static_argnums=1)(jax.random.PRNGKey(seed),
                                                  rcfg)
    pp = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    return rcfg, get_config(arch, smoke=True), rp, pp


@jax.jit
def _top_k_pos(probs, k_e):
    """top_i and the token-major positions of ``_jax_routing``."""
    k, E = k_e.shape
    _, top_i = jax.lax.top_k(probs, k)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    return top_i, jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]


def _jax_routing(probs, cfg, T):
    """The reference's routing lines (``repro/models/moe.py:46-58``) on its
    own probabilities: -> (top_i, keep, slot)."""
    E, k = cfg.n_experts, cfg.top_k
    top_i, pos = _top_k_pos(probs, jnp.zeros((k, E)))
    C = int(np.ceil(T * k / E * cfg.capacity_factor))
    keep = np.asarray(pos) < C
    return np.asarray(top_i), keep, np.where(keep, np.asarray(pos), C - 1)


def _no_ties(probs: np.ndarray, k: int):
    srt = -np.sort(-probs, axis=-1)
    gap = srt[:, k - 1] - srt[:, k] if probs.shape[-1] > k else np.inf
    assert np.all(gap > 0), "a tie at the top-k boundary"


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{b}x{s}" for b, s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_repro(arch, shape):
    rcfg, pcfg, rp, pp = _params(arch)
    B, S = shape
    x = np.random.default_rng(B * 100 + S).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    ry, rprobs = _R_APPLY(rp, jnp.asarray(x), rcfg)
    py, pprobs = PMOE.moe_apply(pp, torch.from_numpy(x), pcfg)
    _no_ties(np.asarray(rprobs), rcfg.top_k)
    torch.testing.assert_close(pprobs, torch.tensor(np.asarray(rprobs)),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(py, torch.tensor(np.asarray(ry)), rtol=1e-5,
                               atol=1e-5)
    T = B * S
    top_i, keep, slot = _jax_routing(rprobs, rcfg, T)
    _, _, p_top_i, p_keep, p_slot, C = PMOE.route(
        pp, torch.from_numpy(x).reshape(T, -1), pcfg)
    assert C == math.ceil(T * rcfg.top_k / rcfg.n_experts
                          * rcfg.capacity_factor)
    np.testing.assert_array_equal(p_top_i.numpy(), top_i)
    np.testing.assert_array_equal(p_keep.numpy(), keep)
    np.testing.assert_array_equal(p_slot.numpy(), slot)
    torch.testing.assert_close(
        PMOE.router_aux_loss(pprobs),
        torch.tensor(float(_R_AUX(rprobs))), rtol=1e-6,
        atol=1e-6)


def test_capacity_drops_match_repro():
    """phi3.5-moe's capacity factor 1.0 at 128 tokens, the inputs leaning
    toward expert 0 (its router column added to every token): expert 0
    overflows and drops assignments, which contribute zero in both
    packages."""
    rcfg, pcfg, rp, pp = _params("phi3.5-moe-42b-a6.6b", seed=1)
    col = np.asarray(rp["router"])[:, 0]
    x = (np.random.default_rng(9).standard_normal((2, 64, rcfg.d_model))
         + 3.0 * col / np.dot(col, col)).astype(np.float32)
    ry, rprobs = _R_APPLY(rp, jnp.asarray(x), rcfg)
    _, keep, _ = _jax_routing(rprobs, rcfg, 128)
    assert not keep.all() and keep.any()
    py, _ = PMOE.moe_apply(pp, torch.from_numpy(x), pcfg)
    torch.testing.assert_close(py, torch.tensor(np.asarray(ry)), rtol=1e-5,
                               atol=1e-5)


def test_ties_go_to_the_lower_expert():
    """With a zero router every expert ties: both packages take experts
    0..k-1, and at one token a time the capacity keeps them all."""
    rcfg, pcfg, rp, pp = _params("olmoe-1b-7b")
    rp = {**rp, "router": jnp.zeros_like(rp["router"])}
    pp = {**pp, "router": torch.zeros_like(pp["router"])}
    x = np.random.default_rng(2).standard_normal(
        (1, 6, rcfg.d_model)).astype(np.float32)
    ry, rprobs = _R_APPLY(rp, jnp.asarray(x), rcfg)
    top_i, keep, slot = _jax_routing(rprobs, rcfg, 6)
    _, _, p_top_i, p_keep, p_slot, _ = PMOE.route(
        pp, torch.from_numpy(x).reshape(6, -1), pcfg)
    assert (top_i == np.arange(rcfg.top_k)).all()
    np.testing.assert_array_equal(p_top_i.numpy(), top_i)
    np.testing.assert_array_equal(p_keep.numpy(), keep)
    np.testing.assert_array_equal(p_slot.numpy(), slot)
    py, _ = PMOE.moe_apply(pp, torch.from_numpy(x), pcfg)
    torch.testing.assert_close(py, torch.tensor(np.asarray(ry)), rtol=1e-5,
                               atol=1e-5)


def test_moe_apply_bf16_and_grad():
    """Under bf16 activations and weights the output keeps bf16; the
    backward reaches every weight, finite.  Inputs leaning toward experts
    0 and 1 overflow both, so late tokens lose both assignments: such a
    token passes y through unchanged (zero output) and gets no gradient
    through the experts or the weights."""
    cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = PMOE.moe_init(gen, cfg)
    cols = p["router"][:, :2].sum(-1)
    x = torch.randn(2, 64, cfg.d_model, generator=gen) \
        + 3.0 * cols / cols.dot(cols)
    yb, _ = PMOE.moe_apply({k: v.bfloat16() for k, v in p.items()},
                           x.bfloat16(), cfg)
    assert yb.dtype == torch.bfloat16 and bool(torch.isfinite(yb).all())
    _, _, _, keep, _, _ = PMOE.route(p, x.reshape(128, -1), cfg)
    gone = ~keep.reshape(128, cfg.top_k).any(-1)
    assert 0 < int(gone.sum()) < 128
    ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xs = x.clone().requires_grad_(True)
    y, probs = PMOE.moe_apply(ps, xs, cfg)
    y.square().sum().backward()
    assert all(bool(torch.isfinite(v.grad).all()) and float(
        v.grad.abs().sum()) > 0 for v in ps.values())
    assert float(y.detach().reshape(128, -1)[gone].abs().max()) == 0.0
    assert float(xs.grad.reshape(128, -1)[gone].abs().max()) == 0.0


def test_recording_routes_and_profiler_ranges():
    """``recording_routes`` collects each ``moe_apply``'s top_i (the
    router's own, nested contexts both), nothing outside the context; under
    torch.profiler the four stages are ranges named ``moe.*``."""
    _, cfg, _, p = _params("olmoe-1b-7b")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    want = PMOE.route(p, x.reshape(10, -1), cfg)[2]
    with PMOE.recording_routes() as outer:
        PMOE.moe_apply(p, x, cfg)
        with PMOE.recording_routes() as inner:
            PMOE.moe_apply(p, x, cfg)
    PMOE.moe_apply(p, x, cfg)
    assert len(outer) == 2 and len(inner) == 1
    assert all(torch.equal(t, want) for t in outer + inner)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        PMOE.moe_apply(p, x, cfg)
    names = {e.name for e in prof.events()}
    assert {"moe.route", "moe.dispatch", "moe.experts",
            "moe.combine"} <= names
