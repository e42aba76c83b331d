"""The LM serving path of repro_torch (prefill, decode_step, ServeEngine)
against the JAX package's on the CPU, at the smoke configs of qwen3-1.7b
(dense GQA, qk_norm) and gemma3-4b (local/global sliding window).

Weights are the JAX package's ``lm.init_params`` carried across by
``params_from_jax``; prompts come from numpy seeds.  Tolerances:
- f32 cache: logits and caches within 5e-5 (absolute and relative) of the
  reference's, greedy tokens equal.  Both run the same f32 algebra in
  another order (and flash decode's online softmax against a dense one).
- bf16 cache: prefill logits as tight as f32 (prefill attends to its own
  f32 k/v); the prefilled k/v within one bf16 ulp beyond the f32
  tolerance (rounded from f32 values that differ in their last bits);
  decode logits and the decoded cache entries within 5e-2.  The reference
  rounds the softmax weights to the cache type before P.V and its output
  to bf16 (``blocks.py:141``); flash decode keeps both in f32, as the TPU
  kernel does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as RB
from repro.models import lm as RLM
from repro.models.registry import get_config as r_get_config
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch.models import blocks as PB
from repro_torch.models import lm as PLM
from repro_torch.models.registry import get_config
from repro_torch.serve import Request, ServeEngine

#: (arch, prompt length, cache length): gemma3-smoke's prompt is longer
#: than its window (64), so its local caches keep the last 64 entries and
#: decode wraps around their ring buffers
CASES = (("qwen3-1.7b", 40, 64), ("gemma3-4b", 70, 96))
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = 5e-5
BF16_DECODE_TOL = 5e-2
STEPS = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    """A JAX array as an f32 tensor (a copy)."""
    return torch.tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def model(request):
    arch, P, L = request.param
    rcfg = r_get_config(arch, smoke=True)
    rparams = RLM.init_params(jax.random.PRNGKey(0), rcfg)
    pparams = PLM.params_from_jax(_np(rparams), device="cpu")
    return rcfg, get_config(arch, smoke=True), rparams, pparams, P, L


def _assert_caches(rcaches, pcaches, kv_tol):
    for rc, pc in zip(rcaches, pcaches):
        for key in ("pos", "idx"):
            np.testing.assert_array_equal(np.asarray(rc[key]),
                                          pc[key].numpy())
        for key in ("k", "v"):
            torch.testing.assert_close(
                pc[key].float(),
                _t(rc[key]), **kv_tol)


@pytest.mark.parametrize("cache", sorted(DTYPES))
def test_prefill_and_decode_match_repro(model, cache):
    rcfg, pcfg, rparams, pparams, P, L = model
    rdt, pdt = DTYPES[cache]
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, P))
    toks = toks.astype(np.int32)

    rl, rc = jax.jit(lambda p, t: RLM.prefill(
        p, rcfg, {"tokens": t}, cache_len=L, cache_dtype=rdt))(
            rparams, jnp.asarray(toks))
    pl, pc = PLM.prefill(pparams, pcfg, {"tokens": torch.from_numpy(toks)},
                         cache_len=L, cache_dtype=pdt)
    torch.testing.assert_close(pl, _t(rl), rtol=TOL, atol=TOL)
    kv_tol = (dict(rtol=TOL, atol=TOL) if cache == "f32"
              else dict(rtol=2.0 ** -7, atol=TOL))     # + one bf16 ulp
    _assert_caches(rc, pc, kv_tol)

    # decode: both fed the reference's greedy tokens
    rdec = jax.jit(lambda p, t, c, po: RLM.decode_step(p, rcfg, t, c, po))
    tol = TOL if cache == "f32" else BF16_DECODE_TOL
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(rl, axis=-1), np.int32)[:, None]
        pos = np.full((2, 1), P + i, np.int32)
        rl, rc = rdec(rparams, jnp.asarray(tok), rc, jnp.asarray(pos))
        pl, pc = PLM.decode_step(pparams, pcfg, torch.tensor(tok), pc,
                                 torch.from_numpy(pos))
        torch.testing.assert_close(pl, _t(rl), rtol=tol, atol=tol)
        if cache == "f32":
            np.testing.assert_array_equal(pl.argmax(-1).numpy(),
                                          np.asarray(jnp.argmax(rl, -1)))
    # the decoded entries come from hidden states that differ as the
    # logits do
    _assert_caches(rc, pc, dict(rtol=tol, atol=tol))


def test_blocks_match_repro():
    """RMSNorm and RoPE (positions up to 32k, qwen3's theta) against the
    reference's, within 1e-5: XLA's and PyTorch's pow, cos and sin differ
    in their last bits."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    pos = rng.integers(0, 32768, (2, 7)).astype(np.int32)
    torch.testing.assert_close(
        PB.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
        _t(RB.rmsnorm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5,
        atol=1e-5)
    torch.testing.assert_close(
        PB.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
        _t(RB.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)


def test_forward_hidden_matches_repro(model):
    rcfg, pcfg, rparams, pparams, P, _ = model
    toks = np.random.default_rng(6).integers(0, rcfg.vocab, (2, P))
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (2, P))
    rh, raux = jax.jit(lambda p, t, po: RLM.forward_hidden(
        p, rcfg, p["embed"][t], po))(rparams, jnp.asarray(toks),
                                     jnp.asarray(pos))
    ph, paux = PLM.forward_hidden(pparams, pcfg,
                                  pparams["embed"][torch.from_numpy(toks)],
                                  torch.from_numpy(pos.copy()))
    torch.testing.assert_close(ph, _t(rh), rtol=TOL, atol=TOL)
    assert float(paux) == float(raux) == 0.0


def test_engine_tokens_match_repro(model):
    """Three requests on two slots (one slot reused), mixed prompt lengths:
    the port's engine emits the reference engine's tokens."""
    rcfg, pcfg, rparams, pparams, _, _ = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32)
               for n in (9, 70, 23)]
    ref = RServeEngine(rparams, rcfg, slots=2, max_len=96,
                       cache_dtype=jnp.float32).run(
        [RRequest(prompt=p, max_new_tokens=5) for p in prompts])
    out = ServeEngine(pparams, pcfg, slots=2, max_len=96,
                      cache_dtype=torch.float32, device="cpu").run(
        [Request(prompt=p, max_new_tokens=5) for p in prompts])
    assert [r.output for r in out] == [r.output for r in ref]
    assert [r.slot for r in out] == [r.slot for r in ref] == [0, 1, 0]


# ---------------------------------------------------------------------------
# ports of tests/integration/test_serve_engine.py
# ---------------------------------------------------------------------------
def _setup():
    cfg = get_config("qwen3-1.7b", smoke=True)
    return cfg, PLM.init_params(cfg, torch.Generator().manual_seed(0))


def _engine(params, cfg, slots):
    return ServeEngine(params, cfg, slots=slots, max_len=64,
                       cache_dtype=torch.float32, device="cpu")


def test_slot_reuse_and_completion():
    cfg, params = _setup()
    eng = _engine(params, cfg, 2)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, 12).astype(np.int32),
                    max_new_tokens=6) for _ in range(5)]
    out = eng.run(reqs)
    assert all(r.done and len(r.output) == 6 for r in out)
    # three waves (2 + 2 + 1 requests) of five decode steps each
    assert eng.stats["prefills"] == 5 and eng.stats["decode_steps"] == 15


def test_submit_rejects_overlong_request():
    """A request that can never fit the KV cache is rejected (marked
    failed): the engine and every other in-flight request keep going."""
    cfg, params = _setup()
    eng = _engine(params, cfg, 2)
    rng = np.random.default_rng(2)
    ok1 = Request(prompt=rng.integers(0, cfg.vocab, 10).astype(np.int32),
                  max_new_tokens=6)
    bad = Request(prompt=rng.integers(0, cfg.vocab, 60).astype(np.int32),
                  max_new_tokens=6)          # 60 + 6 > 64: impossible
    ok2 = Request(prompt=rng.integers(0, cfg.vocab, 10).astype(np.int32),
                  max_new_tokens=6)
    eng.run([ok1, bad, ok2])
    assert bad.done and bad.failed and bad.output == []
    assert "max_len" in bad.error
    assert bad.slot == -1                    # never occupied a slot
    for r in (ok1, ok2):
        assert r.done and not r.failed and len(r.output) == 6
    # the rejected request's tokens never entered a cache: ok2 alone agrees
    alone = Request(prompt=ok2.prompt, max_new_tokens=6)
    assert _engine(params, cfg, 1).run([alone])[0].output == ok2.output


def test_cross_slot_isolation():
    """Mixed prompt lengths in one batch must not interfere (per-row cache
    cursors)."""
    cfg, params = _setup()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (7, 19, 13)]
    together = _engine(params, cfg, 3).run(
        [Request(prompt=p, max_new_tokens=5) for p in prompts])
    for i, p in enumerate(prompts):
        alone = _engine(params, cfg, 1).run(
            [Request(prompt=p, max_new_tokens=5)])[0]
        assert alone.output == together[i].output, (
            f"request {i}: {alone.output} vs {together[i].output}")


# ---------------------------------------------------------------------------
# the registry and the entry points' devices
# ---------------------------------------------------------------------------
def test_unknown_arch_raises_keyerror():
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_entry_points_default_to_the_card():
    """With no card, the engine, the caches, init_params and
    params_from_jax raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run there")
    cfg, params = _setup()
    for call in (lambda: ServeEngine(params, cfg),
                 lambda: PLM.init_caches(cfg, 1, 8),
                 lambda: PLM.init_params(cfg),
                 lambda: PLM.params_from_jax({"w": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_make_cache_defaults_to_the_card():
    """``blocks.make_cache`` runs on the card unless asked for the CPU: with
    no card a call without a device raises, with one the cache lies there."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    cpu = PB.make_cache(cfg, 2, 8, device="cpu")
    assert cpu["k"].device.type == "cpu" and cpu["k"].shape[:2] == (2, 8)
    if torch.cuda.is_available():
        assert PB.make_cache(cfg, 2, 8)["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PB.make_cache(cfg, 2, 8)


def test_rope_freqs_defaults_to_the_card():
    """``blocks.rope_freqs`` runs on the card unless asked for the CPU: with
    no card a call without a device raises, with one the frequencies lie
    there.  On the CPU they equal the ones ``apply_rope`` uses."""
    cpu = PB.rope_freqs(128, 1e6, device="cpu")
    assert cpu.device.type == "cpu" and cpu.shape == (64,)
    assert torch.equal(cpu, PB.rope_freqs(128, 1e6, torch.device("cpu")))
    if torch.cuda.is_available():
        assert PB.rope_freqs(128, 1e6).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PB.rope_freqs(128, 1e6)
