"""Whisper (the encoder-decoder of ``models/whisper.py``), ``blocks.
layernorm``, non-causal attention, the promoted products and the engine's
encoder-decoder admission of repro_torch against the JAX package's, on the
CPU at whisper-smoke (2 + 2 layers, d_model 128, 64 frames).

Weights are the JAX package's ``whisper.init_params`` carried across by
``lm.params_from_jax``; frames and tokens come from numpy seeds.
Tolerances:
- ``layernorm`` within 1e-5 at f32 and one bf16 ulp at bf16; attention,
  ``encode`` and ``_cross_attend`` within 1e-5 (the same f32 algebra in
  another order);
- ``loss_train`` at f32: the loss within 1e-5 (relative), every gradient
  leaf within 1e-5 normwise; under the bf16 view (bf16 copies of the f32
  weights, as the federated runtime trains) with f32 or bf16 frames: the
  loss within 1e-3 and every leaf within 4e-2 normwise, as
  ``tests/test_torch_train.py`` holds the dense stacks (the packages
  round bf16 intermediates at different points).  With f32 frames the
  reference's layer scan refuses to trace (its carry turns f32 after the
  first cross-attention), so that reference runs its layers unrolled
  (``repro.models.unroll.unrolled``, the same function);
- prefill logits and caches within 1e-5, decode logits within 1e-5 and
  greedy tokens equal over an f32 cache; over a bf16 cache the prefilled
  K/V and encoder states within one bf16 ulp beyond that, the decode
  logits within 5e-2 (flash decode keeps its softmax weights in f32, the
  reference rounds them to the cache's type);
- the engine's tokens equal to the reference engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as RB
from repro.models import unroll
from repro.models import whisper as RW
from repro.models.registry import get_config as r_get_config
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch.fed import tree_leaves, tree_unflatten
from repro_torch.models import blocks as PB
from repro_torch.models import lm as PLM
from repro_torch.models import whisper as PW
from repro_torch.models.registry import get_config, model_api
from repro_torch.serve import Request, ServeEngine

TOL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_DECODE_TOL = 5e-2
P, L, STEPS = 40, 72, 3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def model():
    rcfg = r_get_config("whisper-tiny", smoke=True)
    rparams = jax.jit(RW.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    pparams = PLM.params_from_jax(jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    return rcfg, get_config("whisper-tiny", smoke=True), rparams, pparams


def _frames(cfg, B, seed=0, F=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (B, F or cfg.max_source_positions, cfg.d_model)).astype(np.float32)


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()})


def test_registry_and_tree(model):
    """``get_config``/``model_api`` give the port's whisper; its own
    ``init_params`` builds the reference's tree (leaves in
    ``jax.tree.leaves``' order, shapes equal)."""
    rcfg, pcfg, rparams, _ = model
    assert pcfg == get_config("whisper-tiny", smoke=True)
    assert model_api(pcfg) is PW and model_api(get_config("whisper-tiny")) \
        is PW
    mine = PW.init_params(pcfg, torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(mine)] == \
        [a.shape for a in jax.tree.leaves(rparams)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layernorm_matches_repro(dtype):
    rdt, pdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32) * 3
               for s in ((2, 5, 96), (96,), (96,)))
    want = RB.layernorm(jnp.asarray(x, rdt), jnp.asarray(w, rdt),
                        jnp.asarray(b, rdt))
    got = PB.layernorm(torch.tensor(x).to(pdt), torch.tensor(w).to(pdt),
                       torch.tensor(b).to(pdt))
    assert got.dtype == pdt
    tol = dict(rtol=TOL, atol=TOL) if dtype == "f32" else \
        dict(rtol=BF16_ULP, atol=BF16_ULP)
    torch.testing.assert_close(got.float(), _t(want), **tol)


def test_matmul_promotes_as_jnp():
    """bf16 against f32 promotes both to f32 (nothing rounded down), as
    ``jnp.matmul``; equal types are a plain product."""
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.standard_normal((3, 8)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((8, 4)), dtype=torch.bfloat16)
    got = PB.matmul(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, a @ b.float())
    assert torch.equal(PB.matmul(b.T, b), b.T @ b)
    want = jnp.asarray(a.numpy()) @ jnp.asarray(b.float().numpy(),
                                                jnp.bfloat16)
    torch.testing.assert_close(got, _t(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["attn_apply", "k_valid"])
def test_noncausal_attention_matches_repro(model, case):
    """``attn_apply(causal=False)`` at 70 positions; ``_sdpa_chunk``
    non-causal with a key mask (a prefix of keys per row)."""
    rcfg, pcfg, rparams, pparams = model
    rng = np.random.default_rng(3)
    if case == "attn_apply":
        x = rng.standard_normal((2, 70, rcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(70, dtype=np.int32), (2, 70))
        rp = jax.tree.map(lambda a: a[0], rparams["enc"]["attn"])
        pp = {k: v[0] for k, v in pparams["enc"]["attn"].items()}
        (ry, (rk, rv)) = jax.jit(lambda p, x, po: RB.attn_apply(
            p, x, rcfg, po, causal=False))(rp, jnp.asarray(x),
                                           jnp.asarray(pos))
        py, (pk, pv) = PB.attn_apply(pp, torch.from_numpy(x), pcfg,
                                     torch.from_numpy(pos.copy()),
                                     causal=False)
        for got, want in ((py, ry), (pk, rk), (pv, rv)):
            torch.testing.assert_close(got, _t(want), rtol=TOL, atol=TOL)
        return
    q = rng.standard_normal((2, 5, 2, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
            for _ in range(2))
    valid = np.arange(11)[None, :] < np.array([[4], [11]])
    zeros = np.zeros((2, 5), np.int32)
    want = RB._sdpa_chunk(*(jnp.asarray(a) for a in (q, k, v, zeros)),
                          jnp.zeros((2, 11), jnp.int32), None, causal=False,
                          k_valid=jnp.asarray(valid))
    got = PB._sdpa_chunk(*(torch.from_numpy(a) for a in (q, k, v)), None,
                         None, None, causal=False,
                         k_valid=torch.from_numpy(valid))
    torch.testing.assert_close(got, _t(want), rtol=TOL, atol=TOL)


def test_encode_and_cross_attend_match_repro(model):
    """``encode`` over 64 frames (bidirectional, RoPE on the frame index)
    and a decoder layer's ``_cross_attend`` over its states."""
    rcfg, pcfg, rparams, pparams = model
    fr = _frames(rcfg, 2)
    renc = jax.jit(lambda p, f: RW.encode(p, rcfg, f))(rparams,
                                                         jnp.asarray(fr))
    penc = PW.encode(pparams, pcfg, torch.from_numpy(fr))
    torch.testing.assert_close(penc, _t(renc), rtol=TOL, atol=TOL)
    x = np.random.default_rng(4).standard_normal(
        (2, 9, rcfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[1], rparams["dec"]["cross_attn"])
    pp = {k: v[1] for k, v in pparams["dec"]["cross_attn"].items()}
    want = jax.jit(lambda p, x, e: RW._cross_attend(p, x, e, rcfg))(
        rp, jnp.asarray(x), renc)
    got = PW._cross_attend(pp, torch.from_numpy(x), penc, pcfg)
    torch.testing.assert_close(got, _t(want), rtol=TOL, atol=TOL)


def _grads_ref(rcfg, rparams, batch, view, frames):
    """The reference's loss and gradients: f32, or at the bf16 view with
    f32 or bf16 frames (f32 frames through the unrolled layers)."""
    if view == "bf16":
        rparams = jax.tree.map(lambda w: w.astype(jnp.bfloat16), rparams)
    if frames == "bf16":
        batch = {**batch, "frames": batch["frames"].astype(jnp.bfloat16)}
    fn = jax.jit(jax.value_and_grad(lambda p, b: RW.loss_train(p, rcfg, b)))
    if view == "bf16" and frames == "f32":
        with unroll.unrolled():
            return fn(rparams, batch)
    return fn(rparams, batch)


@pytest.mark.parametrize("view,frames", [("f32", "f32"), ("bf16", "f32"),
                                         ("bf16", "bf16")],
                         ids=["f32", "bf16-view-f32-frames",
                              "bf16-view-bf16-frames"])
def test_loss_and_grads_match_repro(model, view, frames):
    rcfg, pcfg, rparams, pparams = model
    tok = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 41))
    tok = tok.astype(np.int32)
    rb, pb = _both({"frames": _frames(rcfg, 2, seed=6),
                    "tokens": tok[:, :-1], "labels": tok[:, 1:]})
    l_ref, g_ref = _grads_ref(rcfg, rparams, rb, view, frames)
    g_ref = [np.asarray(g, np.float32) for g in jax.tree.leaves(g_ref)]
    dt = torch.bfloat16 if view == "bf16" else torch.float32
    if frames == "bf16":
        pb["frames"] = pb["frames"].to(torch.bfloat16)
    xs = [w.to(dt).requires_grad_(True) for w in tree_leaves(pparams)]
    loss = PW.loss_train(tree_unflatten(pparams, xs), pcfg, pb)
    grads = torch.autograd.grad(loss, xs)
    assert loss.dtype == torch.float32
    l_tol, g_tol = (1e-5, 1e-5) if view == "f32" else (1e-3, 4e-2)
    assert abs(float(loss.detach()) - float(l_ref)) <= l_tol * abs(
        float(l_ref))
    assert len(grads) == len(g_ref)
    for g, r in zip(grads, g_ref):
        assert g.dtype == dt and tuple(g.shape) == r.shape
        assert _rel(g.float().numpy(), r) <= g_tol, _rel(g.float().numpy(), r)


def test_repro_scan_refuses_f32_frames_under_bf16():
    """The reference's decoder scan cannot trace the bf16 view with f32
    frames: its carry h enters bf16 and leaves f32 (the cross-attention
    promotes it), so the comparison above unrolls its layers."""
    rcfg = r_get_config("whisper-tiny", smoke=True)
    params = jax.eval_shape(lambda k: RW.init_params(k, rcfg, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    batch = {"frames": jax.ShapeDtypeStruct((1, 8, rcfg.d_model),
                                            jnp.float32),
             "tokens": jax.ShapeDtypeStruct((1, 4), jnp.int32),
             "labels": jax.ShapeDtypeStruct((1, 4), jnp.int32)}
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(lambda p, b: RW.loss_train(p, rcfg, b), params,
                       batch)


def _assert_caches(rc, pc, kv_tol):
    for key in ("pos", "idx"):
        np.testing.assert_array_equal(np.asarray(rc["self"][key]),
                                      pc["self"][key].numpy())
    for got, want in ((pc["self"]["k"], rc["self"]["k"]),
                      (pc["self"]["v"], rc["self"]["v"]),
                      (pc["enc"], rc["enc"])):
        assert tuple(got.shape) == want.shape
        torch.testing.assert_close(got.float(), _t(want), **kv_tol)


@pytest.mark.parametrize("cache", sorted(DTYPES))
def test_prefill_and_decode_match_repro(model, cache):
    rcfg, pcfg, rparams, pparams = model
    rdt, pdt = DTYPES[cache]
    toks = np.random.default_rng(7).integers(0, rcfg.vocab, (2, P))
    rb, pb = _both({"frames": _frames(rcfg, 2, seed=8),
                    "tokens": toks.astype(np.int32)})
    rl, rc = jax.jit(lambda p, b: RW.prefill(
        p, rcfg, b, cache_len=L, cache_dtype=rdt))(rparams, rb)
    pl, pc = PW.prefill(pparams, pcfg, pb, cache_len=L, cache_dtype=pdt)
    torch.testing.assert_close(pl, _t(rl), rtol=TOL, atol=TOL)
    assert pc["enc"].dtype == pdt
    _assert_caches(rc, pc, dict(rtol=TOL, atol=TOL) if cache == "f32"
                   else dict(rtol=BF16_ULP, atol=TOL))
    rdec = jax.jit(lambda p, t, c, po: RW.decode_step(p, rcfg, t, c, po))
    tol = TOL if cache == "f32" else BF16_DECODE_TOL
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(rl, axis=-1), np.int32)[:, None]
        pos = np.full((2, 1), P + i, np.int32)
        rl, rc = rdec(rparams, jnp.asarray(tok), rc, jnp.asarray(pos))
        pl, pc = PW.decode_step(pparams, pcfg, torch.tensor(tok), pc,
                                torch.tensor(pos))
        torch.testing.assert_close(pl.float(), _t(rl), rtol=tol, atol=tol)
        if cache == "f32":
            np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                          np.asarray(jnp.argmax(rl, -1)))
    _assert_caches(rc, pc, dict(rtol=tol, atol=tol))


def test_decode_matches_prefill_continuation(model):
    """A decode step after prefill equals prefilling the longer sequence
    over the same frames (the self-attention cache hand-off and the
    cross-attention through K6's plain version)."""
    _, cfg, _, params = model
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 33)))
    fr = torch.from_numpy(_frames(cfg, 2, seed=10))
    _, caches = PW.prefill(params, cfg, {"frames": fr, "tokens": toks[:, :32]},
                           cache_len=36, cache_dtype=torch.float32)
    ld, _ = PW.decode_step(params, cfg, toks[:, 32:], caches,
                           torch.full((2, 1), 32))
    ll, _ = PW.prefill(params, cfg, {"frames": fr, "tokens": toks},
                       cache_len=36, cache_dtype=torch.float32)
    torch.testing.assert_close(ld, ll, rtol=TOL, atol=TOL)


def test_engine_tokens_match_repro(model):
    """Three requests on two slots (one slot reused), f32 cache, zero
    frames at admission: the port's engine emits the reference engine's
    tokens, and the encoder states land on the slots' axis 0."""
    rcfg, pcfg, rparams, pparams = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32)
               for n in (9, 30, 17)]
    ref = RServeEngine(rparams, rcfg, slots=2, max_len=80,
                       cache_dtype=jnp.float32)
    eng = ServeEngine(pparams, pcfg, slots=2, max_len=80,
                      cache_dtype=torch.float32, device="cpu")
    out = eng.run([Request(prompt=p, max_new_tokens=4) for p in prompts])
    want = ref.run([RRequest(prompt=p, max_new_tokens=4) for p in prompts])
    assert [r.output for r in out] == [r.output for r in want]
    assert [r.slot for r in out] == [r.slot for r in want] == [0, 1, 0]
    assert tuple(eng.caches["enc"].shape) == ref.caches["enc"].shape == \
        (2, rcfg.max_source_positions, rcfg.d_model)
    torch.testing.assert_close(eng.caches["enc"], _t(ref.caches["enc"]),
                               rtol=TOL, atol=TOL)


def test_short_max_len_raises(model):
    """An engine whose max_len is below max_source_positions (64) raises
    ValueError at construction, naming both; the reference's fails at its
    first admission (its encoder cache holds min(64, 40) rows, prefill
    returns 64: ROADMAP.md, Queue 3)."""
    rcfg, pcfg, rparams, pparams = model
    with pytest.raises(ValueError, match=r"max_len \(40\).*\(64\)"):
        ServeEngine(pparams, pcfg, slots=2, max_len=40,
                    cache_dtype=torch.float32, device="cpu")
    ref = RServeEngine(rparams, rcfg, slots=2, max_len=40,
                       cache_dtype=jnp.float32)
    with pytest.raises(ValueError, match="broadcast"):
        ref.submit(RRequest(prompt=np.arange(5, dtype=np.int32),
                            max_new_tokens=2))
    eng = ServeEngine(pparams, pcfg, slots=1, max_len=64,
                      cache_dtype=torch.float32, device="cpu")
    done = eng.run([Request(prompt=np.arange(5, dtype=np.int32),
                            max_new_tokens=2)])
    assert done[0].done and len(done[0].output) == 2


def test_entry_points_default_to_the_card(model):
    """With no card, whisper's init_params, init_caches and an engine over
    it raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run there")
    _, cfg, _, params = model
    for call in (lambda: PW.init_params(cfg),
                 lambda: PW.init_caches(cfg, 1, 64),
                 lambda: ServeEngine(params, cfg, max_len=64)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    caches = PW.init_caches(cfg, 2, 40, device="cpu")
    assert tuple(caches["enc"].shape) == (2, 40, cfg.d_model)
    assert tuple(caches["self"]["k"].shape) == (cfg.n_layers, 2, 40,
                                                cfg.n_kv, cfg.d_head)
