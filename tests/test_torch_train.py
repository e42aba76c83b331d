"""LM training's loss and backward in repro_torch (``models/lm.py``
``loss_train`` under autograd) against the JAX package's ``loss_train``
and ``jax.grad`` of it on the CPU, at the smoke configs of qwen3-1.7b and
gemma3-4b (sliding-window mask), with S = 1,024 (two ``LOSS_CHUNK``
chunks of the vocab projection) and S = 32 (the unchunked branch).

Weights are the JAX package's ``init_params`` carried across by
``params_from_jax``; tokens and labels come from numpy seeds.  Tolerances:
- f32: the loss within 1e-5 (relative), every gradient leaf within 1e-5
  normwise of the reference's (both run the same f32 algebra in another
  order; measured 3e-6 at most).
- the bf16 view (the runtime's forward/backward against bf16 copies of
  f32 weights): the loss within 1e-3 (relative); every gradient leaf within 4e-2
  normwise of the reference's bf16 gradient, and no farther from it than
  1.5x (+ 2e-3) the reference's own bf16 gradient is from its f32 one:
  the two packages round bf16 intermediates at different points, and
  the difference is that rounding (measured 1.1-3.0 % against the
  reference's own 1.3-3.0 %).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as RLM
from repro.models.registry import get_config as r_get_config
from repro_torch.fed import tree_leaves, tree_unflatten
from repro_torch.models import lm as PLM
from repro_torch.models.registry import get_config, model_api

ARCHS = ("qwen3-1.7b", "gemma3-4b")
SEQS = (32, 1024)
B = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _reference(arch: str, S: int):
    """The JAX package's loss and gradients at f32 and at the bf16 view
    (one compile for both), with the inputs."""
    if (arch, S) not in _CACHE:
        rcfg = r_get_config(arch, smoke=True)
        params = RLM.init_params(jax.random.PRNGKey(0), rcfg)
        rng = np.random.default_rng(S)
        tok = rng.integers(0, rcfg.vocab, (B, S + 1)).astype(np.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

        @jax.jit
        def both(p, b):
            f = jax.value_and_grad(lambda q: RLM.loss_train(q, rcfg, b))
            return f(p), f(jax.tree.map(lambda w: w.astype(jnp.bfloat16), p))
        (l32, g32), (l16, g16) = both(params, batch)
        _CACHE[arch, S] = (
            jax.tree.map(np.asarray, params), batch,
            {"f32": (float(l32), [np.asarray(g, np.float32)
                                  for g in jax.tree.leaves(g32)]),
             "bf16": (float(l16), [np.asarray(g, np.float32)
                                   for g in jax.tree.leaves(g16)])})
    return _CACHE[arch, S]


def _port(arch, params, batch, dtype):
    cfg = get_config(arch, smoke=True)
    like = PLM.params_from_jax(params, device="cpu")
    xs = [w.to(dtype).requires_grad_(True) for w in tree_leaves(like)]
    loss = model_api(cfg).loss_train(
        tree_unflatten(like, xs), cfg,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, xs)
    return float(loss.detach()), [g.to(torch.float32).numpy()
                                  for g in grads]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_f32(arch, S):
    params, batch, ref = _reference(arch, S)
    loss, grads = _port(arch, params, batch, torch.float32)
    l_ref, g_ref = ref["f32"]
    assert abs(loss - l_ref) <= 1e-5 * abs(l_ref)
    assert len(grads) == len(g_ref)
    for g, r in zip(grads, g_ref):
        assert g.shape == r.shape and _rel(g, r) <= 1e-5


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_bf16_view(arch, S):
    params, batch, ref = _reference(arch, S)
    loss, grads = _port(arch, params, batch, torch.bfloat16)
    l_ref, g_ref = ref["bf16"]
    assert abs(loss - l_ref) <= 1e-3 * abs(l_ref)
    for g, r, r32 in zip(grads, g_ref, ref["f32"][1]):
        own = _rel(r, r32)
        assert _rel(g, r) <= min(4e-2, 1.5 * own + 2e-3), (_rel(g, r), own)


def test_chunked_loss_is_the_unchunked_loss(monkeypatch):
    """The chunked vocab projection sums the same cross entropies as one
    projection (within f32 summation order), and its gradients likewise."""
    params, batch, _ = _reference("qwen3-1.7b", 1024)
    loss, grads = _port("qwen3-1.7b", params, batch, torch.float32)
    monkeypatch.setattr(PLM, "LOSS_CHUNK", 2048)
    loss1, grads1 = _port("qwen3-1.7b", params, batch, torch.float32)
    assert abs(loss - loss1) <= 1e-6 * abs(loss1)
    for g, g1 in zip(grads, grads1):
        assert _rel(g, g1) <= 1e-6


def test_model_api_carries_training():
    """``model_api`` gives init_params and loss_train for the dense stacks;
    the untied head is trained too."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              tie_embeddings=False, n_layers=1)
    api = model_api(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    xs = [w.requires_grad_(True) for w in tree_leaves(params)]
    tok = torch.randint(0, cfg.vocab, (2, 9),
                        generator=torch.Generator().manual_seed(1))
    loss = api.loss_train(tree_unflatten(params, xs), cfg,
                          {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    grads = torch.autograd.grad(loss, xs)
    assert "lm_head" in params and loss.dtype == torch.float32
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    head = [i for i, w in enumerate(xs) if w is params["lm_head"]]
    assert len(head) == 1 and float(grads[head[0]].abs().sum()) > 0
