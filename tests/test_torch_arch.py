"""The MoE, hybrid, xLSTM, VLM and large dense LM stacks of repro_torch
(``models/lm.py`` with ``attn_moe``, ``mamba2``, ``shared_attn``,
``mlstm`` and ``slstm`` blocks and M-RoPE, ``ServeEngine``) against the
JAX package's on the CPU, at the smoke configs of olmoe-1b-7b, phi3.5-moe,
zamba2-2.7b, xlstm-1.3b, qwen2-vl-7b, llama3-405b and mistral-large-123b;
the ports of ``tests/integration/test_arch_smoke.py`` for every arch the
port carries (whisper-tiny's encoder-decoder among them, its batch with
frames; whisper's parity tests are ``tests/test_torch_whisper.py``); and
``chip_smoke.py``'s parameter and K6-launch counts against the parameter
tree and a counted decode step.

A VLM batch (qwen2-vl) carries numpy-seeded patch embeddings over the
first quarter of the positions and three unequal M-RoPE streams (t, t // 4,
t % 4 from a per-row offset); the engine admits requests as the
reference's does (zero patch embeddings, equal streams).

Weights are the JAX package's ``init_params`` carried across by
``params_from_jax``; tokens come from numpy seeds.  Tolerances:
- prefill and decode over an f32 cache: logits and caches within 1e-4 of
  the reference's, greedy tokens equal (the same f32 algebra in another
  order; routing equal, since a flipped expert would move a logit by far
  more);
- ``loss_train`` within 1e-5 (relative) and every gradient leaf within
  1e-5 normwise of ``jax.value_and_grad``'s, the router's aux term
  included, but mamba2's per-head leaves (``A_log``, ``D``, ``dt_bias``: 8
  numbers a layer) within 5e-5: their gradients sum terms of both signs
  over every token (``A_log`` over every position pair), and each
  package's f32 values lie up to 1.7e-5 (``A_log``), 9.7e-6
  (``dt_bias``) and 7.9e-6 (``D``) from a float64 evaluation of the port
  (measured at this test's inputs; every other leaf 1e-6 - 6e-6); the aux
  loss of ``forward_hidden`` within 1e-6;
- the engine's tokens equal to the reference engine's over the same
  request order.  Under MoE a slot's tokens depend on the other slots
  (every slot's token, idle ones too, takes expert capacity in token
  order), so the dense isolation test does not carry over.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as RLM
from repro.models.registry import get_config as r_get_config
from repro.models.registry import model_api as r_model_api
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch.fed import tree_leaves, tree_unflatten
from repro_torch.models import blocks as PB
from repro_torch.models import lm as PLM
from repro_torch.models import whisper as PW
from repro_torch.models.registry import ARCH_IDS, get_config, model_api
from repro_torch.serve import Request, ServeEngine

ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
         "xlstm-1.3b", "qwen2-vl-7b", "llama3-405b", "mistral-large-123b")
TOL = 1e-4
P, L, STEPS = 40, 64, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        rcfg = r_get_config(arch, smoke=True)
        rparams = jax.jit(RLM.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), rcfg)
        _MODELS[arch] = (rcfg, get_config(arch, smoke=True), rparams,
                         PLM.params_from_jax(_np(rparams), device="cpu"))
    return _MODELS[arch]


def _vlm_leaves(cfg, B, S, seed=9):
    """A VLM batch's extra leaves as numpy: patch embeddings (B, S // 4, D)
    and positions3 (3, B, S) = (t, t // 4, t % 4) from a per-row
    offset."""
    if cfg.family != "vlm":
        return {}
    rng = np.random.default_rng(seed)
    t = np.arange(S) + rng.integers(0, 50, (B, 1))
    return {"patch_embeds": rng.standard_normal(
                (B, int(S * cfg.vision_patches_frac),
                 cfg.d_model)).astype(np.float32),
            "positions3": np.stack([t, t // 4, t % 4]).astype(np.int32)}


def _both(batch):
    """A numpy batch as the reference's (jnp) and the port's (torch)."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()})


def _assert_caches(rcaches, pcaches, tol):
    assert len(rcaches) == len(pcaches)
    for rc, pc in zip(rcaches, pcaches):
        assert sorted(rc) == sorted(pc)
        for key, leaf in pc.items():
            assert tuple(leaf.shape) == rc[key].shape, key
            if leaf.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(np.asarray(rc[key]),
                                              leaf.numpy())
            else:
                torch.testing.assert_close(leaf.float(), _t(rc[key]),
                                           rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_repro(arch):
    rcfg, pcfg, rparams, pparams = _model(arch)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, P))
    rb, pb = _both({"tokens": toks.astype(np.int32),
                    **_vlm_leaves(rcfg, 2, P)})
    rl, rc = jax.jit(lambda p, b: RLM.prefill(
        p, rcfg, b, cache_len=L, cache_dtype=jnp.float32))(rparams, rb)
    pl, pc = PLM.prefill(pparams, pcfg, pb, cache_len=L,
                         cache_dtype=torch.float32)
    torch.testing.assert_close(pl, _t(rl), rtol=TOL, atol=TOL)
    _assert_caches(rc, pc, TOL)
    rdec = jax.jit(lambda p, t, c, po: RLM.decode_step(p, rcfg, t, c, po))
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(rl, axis=-1), np.int32)[:, None]
        pos = np.full((2, 1), P + i, np.int32)
        rl, rc = rdec(rparams, jnp.asarray(tok), rc, jnp.asarray(pos))
        pl, pc = PLM.decode_step(pparams, pcfg, torch.tensor(tok), pc,
                                 torch.tensor(pos))
        torch.testing.assert_close(pl, _t(rl), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(rl, -1)))
    _assert_caches(rc, pc, TOL)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch):
    """f32, S = 48, aux weight 0.5 (so the router's term moves the loss
    and the router gradients visibly)."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    rng = np.random.default_rng(11)
    tok = rng.integers(0, rcfg.vocab, (2, 49)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             **_vlm_leaves(rcfg, 2, 48)}
    rb, pb = _both(batch)
    l_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p, b: RLM.loss_train(p, rcfg, b, aux_weight=0.5)))(
            rparams, rb)
    g_ref = [np.asarray(g, np.float32) for g in jax.tree.leaves(g_ref)]
    xs = [w.clone().requires_grad_(True) for w in tree_leaves(pparams)]
    loss = model_api(pcfg).loss_train(tree_unflatten(pparams, xs), pcfg, pb,
                                      aux_weight=0.5)
    grads = torch.autograd.grad(loss, xs)
    assert abs(float(loss.detach()) - float(l_ref)) <= 1e-5 * abs(float(l_ref))
    assert len(grads) == len(g_ref)
    heads = {id(seg["mamba"][k]) for seg in pparams["segments"]
             if "mamba" in seg for k in ("A_log", "D", "dt_bias")}
    for w, g, r in zip(tree_leaves(pparams), grads, g_ref):
        tol = 5e-5 if id(w) in heads else 1e-5
        assert tuple(g.shape) == r.shape and _rel(g.numpy(), r) <= tol


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_aux_matches_repro(arch):
    """The aux loss sums the router losses of the attn_moe layers (0 for
    zamba2, which has none)."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    toks = np.random.default_rng(6).integers(0, rcfg.vocab, (2, 33))
    pos = _vlm_leaves(rcfg, 2, 33).get(
        "positions3", np.broadcast_to(np.arange(33, dtype=np.int32), (2, 33)))
    rh, raux = jax.jit(lambda p, t, po: RLM.forward_hidden(
        p, rcfg, p["embed"][t], po))(rparams, jnp.asarray(toks),
                                     jnp.asarray(pos))
    ph, paux = PLM.forward_hidden(pparams, pcfg,
                                  pparams["embed"][torch.from_numpy(toks)],
                                  torch.from_numpy(pos.copy()))
    torch.testing.assert_close(ph, _t(rh), rtol=TOL, atol=TOL)
    assert abs(float(paux) - float(raux)) <= 1e-6
    assert (float(paux) > 0) == (pcfg.family == "moe")


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "zamba2-2.7b", "xlstm-1.3b",
                                  "qwen2-vl-7b", "llama3-405b",
                                  "mistral-large-123b"))
def test_engine_tokens_match_repro(arch):
    """Three requests on two slots (one slot reused), f32 cache: the
    port's engine emits the reference engine's tokens (a VLM request
    admitted with its patch embeddings and M-RoPE streams)."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32)
               for n in (9, 30, 17)]
    ref = RServeEngine(rparams, rcfg, slots=2, max_len=48,
                       cache_dtype=jnp.float32).run(
        [RRequest(prompt=p, max_new_tokens=4) for p in prompts])
    out = ServeEngine(pparams, pcfg, slots=2, max_len=48,
                      cache_dtype=torch.float32, device="cpu").run(
        [Request(prompt=p, max_new_tokens=4) for p in prompts])
    assert [r.output for r in out] == [r.output for r in ref]
    assert [r.slot for r in out] == [r.slot for r in ref] == [0, 1, 0]


def test_splice_casts_the_ssm_state():
    """zamba2 over a bf16 cache: prefill's f32 conv tail lands in the
    slot rounded through bf16, as the reference's splice casts it, into
    an f32 leaf (the reference's leaf after its first decode step), and
    the state h as it is; the other slot is untouched."""
    _, cfg, _, params = _model("zamba2-2.7b")
    eng = ServeEngine(params, cfg, slots=2, max_len=32,
                      cache_dtype=torch.bfloat16, device="cpu")
    prompt = np.arange(5, 17, dtype=np.int32)
    _, one = PLM.prefill(params, cfg,
                         {"tokens": torch.from_numpy(prompt)[None].long()},
                         cache_len=32, cache_dtype=torch.bfloat16)
    assert eng.submit(Request(prompt=prompt, max_new_tokens=2))
    for (btype, _), full, mine in zip(cfg.segments, eng.caches, one):
        if btype != "mamba2":
            continue
        assert mine["conv"].dtype == torch.float32
        assert full["conv"].dtype == torch.float32
        assert full["h"].dtype == torch.float32
        assert torch.equal(full["conv"][:, :1],
                           mine["conv"].to(torch.bfloat16).float())
        assert torch.equal(full["h"][:, :1], mine["h"])
        assert not full["conv"][:, 1:].any() and not full["h"][:, 1:].any()


def _ssm_gap(rcaches, pcaches, segments):
    """The largest normwise relative gap of the SSM state leaves."""
    return max(_rel(pc[k].float().numpy(), np.asarray(rc[k], np.float32))
               for (btype, _), rc, pc in zip(segments, rcaches, pcaches)
               if btype == "mamba2" for k in ("h", "conv"))


def test_engine_bf16_cache_tracks_repro():
    """zamba2 served over a bf16 cache, three requests on two slots, the
    third admitted after two decode steps: the tokens equal the reference
    engine's.  The SSM state stays within 1e-4 (normwise) of the
    reference's while only the first two requests ran: both engines round
    their conv tails on admission and decode in f32.  The third request's
    tail the port rounds too, the reference not (its leaf is f32 by then),
    so from that step the state stays within 5e-3 (measured 1.4e-3) and
    the gap does not grow: a conv leaf kept in bf16 and rounded every step
    drifted to 5.7e-3 in 8 steps."""
    rcfg, pcfg, rparams, pparams = _model("zamba2-2.7b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32)
               for n in (9, 30, 17)]
    news = (3, 10, 6)
    ref = RServeEngine(rparams, rcfg, slots=2, max_len=48,
                       cache_dtype=jnp.bfloat16)
    eng = ServeEngine(pparams, pcfg, slots=2, max_len=48,
                      cache_dtype=torch.bfloat16, device="cpu")
    rreqs = [RRequest(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    preqs = [Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    for e, reqs in ((ref, rreqs), (eng, preqs)):
        assert e.submit(reqs[0]) and e.submit(reqs[1])
    for i in range(10):
        ref.step()
        eng.step()
        gap = _ssm_gap(ref.caches, eng.caches, pcfg.segments)
        assert gap <= (1e-4 if i < 2 else 5e-3), (i, gap)
        if i == 1:
            assert rreqs[0].done and preqs[0].done
            assert ref.submit(rreqs[2]) and eng.submit(preqs[2])
    assert all(r.done for r in preqs + rreqs)
    assert [r.output for r in preqs] == [r.output for r in rreqs]


@pytest.mark.parametrize("n", [1, 2])
def test_short_hybrid_prompt_raises(n):
    """A hybrid prompt shorter than ssm_conv - 1 = 3 tokens raises at
    admission and takes no slot (the reference's splice would replace the
    whole cache leaf, ROADMAP.md, Queue 3)."""
    _, cfg, _, params = _model("zamba2-2.7b")
    eng = ServeEngine(params, cfg, slots=2, max_len=32,
                      cache_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="conv tail"):
        eng.submit(Request(prompt=np.arange(n, dtype=np.int32),
                           max_new_tokens=2))
    assert eng.active == [None, None]
    ok = eng.run([Request(prompt=np.arange(3, dtype=np.int32),
                          max_new_tokens=2)])
    assert ok[0].done and len(ok[0].output) == 2


def test_tree_leaves_puts_shared_after_segments():
    """jax.tree.leaves' order: "shared" (zamba2's weight-shared block)
    sorts after "segments", and the port's leaves follow it."""
    rcfg, _, rparams, pparams = _model("zamba2-2.7b")
    assert [tuple(t.shape) for t in tree_leaves(pparams)] == \
        [a.shape for a in jax.tree.leaves(rparams)]
    keys = sorted(pparams)
    assert keys.index("segments") < keys.index("shared") == len(keys) - 1
    shared = tree_leaves(pparams["shared"])
    assert all(a is b for a, b in zip(tree_leaves(pparams)[-len(shared):],
                                      shared))


def test_decode_matches_prefill_continuation():
    """zamba2: a decode step after prefill equals prefilling the longer
    sequence (the mamba2 state hand-off and the shared block's caches).
    MoE has no such identity: its capacity depends on the tokens batched."""
    _, cfg, _, params = _model("zamba2-2.7b")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 33)))
    _, caches = PLM.prefill(params, cfg, {"tokens": toks[:, :32]},
                            cache_len=36, cache_dtype=torch.float32)
    ld, _ = PLM.decode_step(params, cfg, toks[:, 32:], caches,
                            torch.full((2, 1), 32))
    ll, _ = PLM.prefill(params, cfg, {"tokens": toks}, cache_len=36,
                        cache_dtype=torch.float32)
    torch.testing.assert_close(ld, ll, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# ports of tests/integration/test_arch_smoke.py, every arch the port carries
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=64):
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    if cfg.family == "vlm":
        npatch = int(S * cfg.vision_patches_frac)
        batch["patch_embeds"] = torch.randn(B, npatch, cfg.d_model,
                                            generator=gen)
        pos = torch.arange(S).expand(B, S)
        batch["positions3"] = torch.stack([pos, pos, pos])
    if cfg.encdec:
        batch["frames"] = torch.randn(B, cfg.max_source_positions,
                                      cfg.d_model, generator=gen)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    cfg = get_config(arch, smoke=True)
    assert cfg.d_model <= 512
    assert cfg.n_layers <= 2 * len(cfg.pattern) + 1
    if cfg.n_experts:
        assert cfg.n_experts <= 4
    api = model_api(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    xs = [w.requires_grad_(True) for w in tree_leaves(params)]
    loss = api.loss_train(tree_unflatten(params, xs), cfg, batch)
    grads = torch.autograd.grad(loss, xs)
    assert loss.shape == () and bool(torch.isfinite(loss)), arch
    assert all(bool(torch.isfinite(g).all()) for g in grads), arch
    # one SGD step moves the loss
    with torch.no_grad():
        p2 = tree_unflatten(params, [w - 0.1 * g for w, g in zip(xs, grads)])
        loss2 = api.loss_train(p2, cfg, batch)
    assert bool(torch.isfinite(loss2))
    assert float(loss2) < float(loss.detach()) + 0.5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode(arch):
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 64
    with torch.no_grad():
        logits, caches = api.prefill(params, cfg, _batch(cfg, B, S),
                                     cache_len=S + 8)
        assert logits.shape == (B, cfg.vocab)
        assert bool(torch.isfinite(logits).all()), arch
        tok = logits.argmax(-1)[:, None]
        logits2, _ = api.decode_step(params, cfg, tok, caches,
                                     torch.full((B, 1), S))
    assert logits2.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits2).all()), arch


def test_param_counts_sane():
    """The full configs in the advertised ballpark, and each smoke
    config's parameter tree against ``param_count`` where they count the
    same things (norms, the SSM's small leaves and zamba2's sharing
    aside)."""
    approx = {"qwen3-1.7b": (1.2e9, 2.6e9), "gemma3-4b": (3e9, 6e9),
              "olmoe-1b-7b": (5e9, 9e9),
              "phi3.5-moe-42b-a6.6b": (3.4e11 / 10, 6e10),
              "zamba2-2.7b": (1.8e9, 4e9),
              "mistral-large-123b": (1.0e11, 1.4e11),
              "llama3-405b": (3.6e11, 4.4e11), "xlstm-1.3b": (0.8e9, 2.4e9),
              "qwen2-vl-7b": (6e9, 9.5e9), "whisper-tiny": (2e7, 8e7)}
    assert sorted(approx) == sorted(ARCH_IDS)
    for arch, (lo, hi) in approx.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, (arch, f"{n:.3g}")
    for arch in ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b",
                 "llama3-405b", "mistral-large-123b"):
        cfg = get_config(arch, smoke=True)
        params = PLM.init_params(cfg, torch.Generator().manual_seed(0))
        n = sum(t.numel() for t in tree_leaves(params))
        assert n == cfg.param_count() + cfg.d_model \
            + 2 * cfg.n_layers * cfg.d_head * cfg.qk_norm


# ---------------------------------------------------------------------------
# chip_smoke.py's counts from a config, against the tree and a decode step
# ---------------------------------------------------------------------------
def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_count_matches_the_tree(arch):
    """``chip_smoke.param_tree_count`` counts the parameters of the port's
    tree at each smoke config and the reference's abstract tree at each
    full config (xlstm-1.3b 3,468,498,944, qwen2-vl-7b 7,070,490,112,
    whisper-tiny 41,158,272 and whisper-smoke 853,504)."""
    count = _chip_smoke().param_tree_count
    cfg = get_config(arch, smoke=True)
    params = model_api(cfg).init_params(cfg,
                                        torch.Generator().manual_seed(0))
    assert count(cfg) == sum(t.numel() for t in tree_leaves(params))
    rcfg = r_get_config(arch)
    full = r_model_api(rcfg).abstract_params(rcfg)
    assert count(get_config(arch)) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(full))
    want = {"xlstm-1.3b": 3_468_498_944, "qwen2-vl-7b": 7_070_490_112,
            "whisper-tiny": 41_158_272}
    if arch in want:
        assert count(get_config(arch)) == want[arch]
    if arch == "whisper-tiny":
        assert count(cfg) == 853_504


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_k6_layers_counts_decode_launches(arch, monkeypatch):
    """``chip_smoke.k6_layers`` is the number of flash-decode (K6) calls a
    decode step makes at each smoke config: one an attention layer, none
    for mamba2, mlstm and slstm layers, two a decoder layer of whisper
    (its self- and cross-attention)."""
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    real = PB.flash_decode
    monkeypatch.setattr(PB, "flash_decode", counting)
    monkeypatch.setattr(PW, "flash_decode", counting)
    with torch.no_grad():
        _, caches = api.prefill(params, cfg, _batch(cfg, 1, 8),
                                cache_len=12)
        api.decode_step(params, cfg, torch.zeros(1, 1, dtype=torch.int64),
                        caches, torch.full((1, 1), 8))
    assert len(calls) == _chip_smoke().k6_layers(cfg)
    assert (len(calls) == 0) == (arch == "xlstm-1.3b")
