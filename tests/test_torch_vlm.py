"""The VLM path of repro_torch (qwen2-vl: M-RoPE in ``models/blocks.py``,
patch embeddings and positions3 in ``models/lm.py``, the engine's
admission, and ``fed/runtime.py``'s micro-batch split of positions3)
against the JAX package's on the CPU, at qwen2-vl-7b's smoke config
(d_model 256, 4 heads of 64 over 2 kv heads, sections (8, 12, 12)).

Inputs come from numpy seeds.  Tolerances: ``apply_mrope`` within 1e-6 of
the reference's (the same angles, each package's cos and sin); on equal
streams it is RoPE within 1e-6 (the port of
``tests/unit/test_blocks.py::test_mrope_reduces_to_rope_on_equal_streams``);
the engine's tokens equal to the reference engine's; the micro-batch split
exact (slices of the batch).
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
from repro_torch.fed import runtime as RT
from repro_torch.models import blocks as PB
from repro_torch.models import lm as PLM
from repro_torch.models.registry import get_config
from repro_torch.serve import Request, ServeEngine

ARCH = "qwen2-vl-7b"


def _x(cfg, seed, S=16):
    return np.random.default_rng(seed).standard_normal(
        (2, S, 4, cfg.d_head)).astype(np.float32)


def test_mrope_reduces_to_rope_on_equal_streams():
    """With t == h == w position streams, M-RoPE equals standard RoPE."""
    cfg = get_config(ARCH, smoke=True)
    x = torch.from_numpy(_x(cfg, 1))
    pos = torch.arange(16).expand(2, 16)
    pos3 = torch.stack([pos, pos, pos])
    a = PB.apply_rope(x, pos, cfg.rope_theta)
    b = PB.apply_mrope(x, pos3, cfg.rope_theta, cfg.mrope_sections)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-7b-full"])
def test_apply_mrope_matches_repro_on_unequal_streams(arch):
    """Three different streams (positions up to 4,096), at the smoke
    config's sections and at the full config's (16, 24, 24) over dh 128."""
    full = arch.endswith("-full")
    cfg = get_config(ARCH, smoke=not full)
    rng = np.random.default_rng(7)
    x = _x(cfg, 2)
    pos3 = rng.integers(0, 4096, (3, 2, 16)).astype(np.int32)
    want = RB.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), cfg.rope_theta,
                          cfg.mrope_sections)
    got = PB.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                         cfg.rope_theta, cfg.mrope_sections)
    torch.testing.assert_close(got, torch.tensor(np.asarray(want)),
                               rtol=1e-6, atol=1e-6)
    # each stream moves only its own frequency bands
    other = pos3.copy()
    other[2] += 1
    moved = PB.apply_mrope(torch.from_numpy(x), torch.from_numpy(other),
                           cfg.rope_theta, cfg.mrope_sections) != got
    half = cfg.d_head // 2
    band = sum(cfg.mrope_sections[:2])
    for lo in (0, half):     # the rotated halves x1, x2
        assert not moved[..., lo:lo + band].any()
        assert moved[..., lo + band:lo + half].any()


def test_mrope_sections_must_sum_to_half_the_head():
    cfg = get_config(ARCH, smoke=True)
    x = torch.zeros(1, 2, 4, cfg.d_head)
    with pytest.raises(ValueError, match="mrope_sections"):
        PB.apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int64),
                       cfg.rope_theta, (8, 12, 11))


@pytest.mark.parametrize("M", [2, 3])
def test_micro_splits_positions3_on_its_batch_axis(M):
    """A step's batch at ``microbatch`` M: tokens, labels and patch
    embeddings split on axis 0, positions3 (3, B, S) on its B axis, never
    across its streams; micro-batch m holds rows m*B/M .. (m+1)*B/M of
    every leaf."""
    B, S = 6, 5
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 50, (B, S), generator=gen),
             "patch_embeds": torch.randn(B, 1, 8, generator=gen),
             "positions3": torch.randint(0, 50, (3, B, S), generator=gen)}
    k = B // M
    for m in range(M):
        micro = {key: RT._micro(v, M, m, RT._batch_axis(key))
                 for key, v in batch.items()}
        rows = slice(m * k, (m + 1) * k)
        assert torch.equal(micro["tokens"], batch["tokens"][rows])
        assert torch.equal(micro["patch_embeds"], batch["patch_embeds"][rows])
        assert micro["positions3"].shape == (3, k, S)
        assert torch.equal(micro["positions3"], batch["positions3"][:, rows])
    # a leaf M does not divide goes whole, as the reference broadcasts it
    odd = torch.zeros(5, 2)
    assert RT._micro(odd, 2, 1) is odd


@pytest.fixture(scope="module")
def model():
    rcfg = r_get_config(ARCH, smoke=True)
    rparams = jax.jit(RLM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    return rcfg, get_config(ARCH, smoke=True), rparams, PLM.params_from_jax(
        jax.tree.map(np.asarray, rparams), device="cpu")


def test_engine_short_prompts_take_one_patch(model):
    """Prompts of 2 and 3 tokens take max(1, int(P / 4)) = 1 patch row, as
    the reference's admission does: the tokens equal its engine's."""
    rcfg, pcfg, rparams, pparams = model
    prompts = [np.array([5, 9], np.int32), np.array([7, 1, 3], np.int32),
               np.arange(11, 20, dtype=np.int32)]
    ref = RServeEngine(rparams, rcfg, slots=2, max_len=24,
                       cache_dtype=jnp.float32).run(
        [RRequest(prompt=p, max_new_tokens=3) for p in prompts])
    out = ServeEngine(pparams, pcfg, slots=2, max_len=24,
                      cache_dtype=torch.float32, device="cpu").run(
        [Request(prompt=p, max_new_tokens=3) for p in prompts])
    assert [r.output for r in out] == [r.output for r in ref]


def test_decode_broadcasts_positions_to_the_streams(model):
    """decode_step's (B, 1) positions go to all three M-RoPE streams: the
    step equals a prefill continuation on equal streams whose last
    position is that step's."""
    _, cfg, _, params = model
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 17)))
    pos = torch.arange(17).expand(2, 17)
    pe = torch.zeros(2, 4, cfg.d_model)

    def batch(n):
        return {"tokens": toks[:, :n], "patch_embeds": pe,
                "positions3": torch.stack([pos[:, :n]] * 3)}
    _, caches = PLM.prefill(params, cfg, batch(16), cache_len=20,
                            cache_dtype=torch.float32)
    assert torch.equal(caches[0]["pos"][:, :, :16], pos[:, :16].expand(
        2, 2, 16).to(torch.int32))
    ld, _ = PLM.decode_step(params, cfg, toks[:, 16:], caches,
                            torch.full((2, 1), 16))
    ll, _ = PLM.prefill(params, cfg, batch(17), cache_len=20,
                        cache_dtype=torch.float32)
    torch.testing.assert_close(ld, ll, rtol=2e-3, atol=2e-3)
