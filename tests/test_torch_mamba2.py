"""The Mamba2 (SSD) mixer of repro_torch (``models/mamba2.py``) against the
JAX package's (``repro/models/mamba2.py``) on the CPU, at zamba2-2.7b's
smoke config (d_model 256, 8 heads of 64, ssm_state 16).

Weights are the JAX package's ``mamba2_init`` carried across; inputs come
from numpy seeds.  S in {64, 200, 256}: below one chunk, one chunk of S
(200 is no multiple of 128) and two chunks of 128.  Tolerances:
- ``mamba2_apply``'s y, final state h and conv tail within 1e-5 of the
  reference's (the same f32 algebra, contracted in another order);
- ``mamba2_decode`` step by step from the reference's own prefill state,
  y and the state within 1e-5 at every step;
- the ports of ``tests/integration/test_recurrent_consistency.py``'s two
  mamba2 tests hold the parallel form against the recurrence within
  their 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as RM2
from repro.models.registry import get_config as r_get_config
from repro_torch.models import mamba2 as PM2
from repro_torch.models.registry import get_config

ARCH = "zamba2-2.7b"
SEQS = (64, 200, 256)
TOL = 1e-5
_R_APPLY = jax.jit(lambda p, x, cfg: RM2.mamba2_apply(p, x, cfg,
                                                      return_state=True),
                   static_argnums=2)
_R_DECODE = jax.jit(RM2.mamba2_decode, static_argnums=2)


@pytest.fixture(scope="module")
def mixer():
    rcfg = r_get_config(ARCH, smoke=True)
    rp = jax.jit(RM2.mamba2_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                    rcfg)
    pp = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    return rcfg, get_config(ARCH, smoke=True), rp, pp


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _x(cfg, B, S, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("S", SEQS)
def test_mamba2_apply_matches_repro(mixer, S):
    rcfg, pcfg, rp, pp = mixer
    x = _x(rcfg, 2, S, S)
    ry, rst = _R_APPLY(rp, jnp.asarray(x), rcfg)
    py, pst = PM2.mamba2_apply(pp, torch.from_numpy(x), pcfg,
                               return_state=True)
    torch.testing.assert_close(py, _t(ry), rtol=TOL, atol=TOL)
    for k in ("h", "conv"):
        assert pst[k].shape == rst[k].shape
        torch.testing.assert_close(pst[k], _t(rst[k]), rtol=TOL, atol=TOL)
    # without the state: the same y
    assert torch.equal(PM2.mamba2_apply(pp, torch.from_numpy(x), pcfg), py)


@pytest.mark.parametrize("S", SEQS)
def test_mamba2_decode_matches_repro(mixer, S):
    """Four decode steps from each package's own prefill state, the
    reference fed its own state and the port its own: y and the state
    within 1e-5 at every step."""
    rcfg, pcfg, rp, pp = mixer
    x = _x(rcfg, 2, S + 4, 100 + S)
    _, rst = _R_APPLY(rp, jnp.asarray(x[:, :S]), rcfg)
    _, pst = PM2.mamba2_apply(pp, torch.from_numpy(x[:, :S]), pcfg,
                              return_state=True)
    pst = {k: v.clone() for k, v in pst.items()}
    for t in range(S, S + 4):
        ry, rst = _R_DECODE(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rst)
        py, out = PM2.mamba2_decode(pp, torch.from_numpy(x[:, t:t + 1]),
                                    pcfg, pst)
        assert out is pst                       # updated in place
        torch.testing.assert_close(py, _t(ry), rtol=TOL, atol=TOL)
        for k in ("h", "conv"):
            torch.testing.assert_close(pst[k], _t(rst[k]), rtol=TOL,
                                       atol=TOL)


def test_decode_from_an_empty_state_matches_repro(mixer):
    rcfg, pcfg, rp, pp = mixer
    x = _x(rcfg, 3, 6, 7)
    rst = RM2.make_ssm_state(rcfg, 3)
    pst = PM2.make_ssm_state(pcfg, 3, device="cpu")
    assert all(pst[k].shape == rst[k].shape for k in ("h", "conv"))
    for t in range(6):
        ry, rst = _R_DECODE(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rst)
        py, _ = PM2.mamba2_decode(pp, torch.from_numpy(x[:, t:t + 1]), pcfg,
                                  pst)
        torch.testing.assert_close(py, _t(ry), rtol=TOL, atol=TOL)


def _stepwise(p, x, cfg):
    st = PM2.make_ssm_state(cfg, x.shape[0], device="cpu")
    return torch.cat([PM2.mamba2_decode(p, x[:, t:t + 1], cfg, st)[0]
                      for t in range(x.shape[1])], dim=1)


# ports of tests/integration/test_recurrent_consistency.py's mamba2 tests
@pytest.mark.parametrize("S", [32, 2 * PM2.CHUNK],
                         ids=["one-chunk", "chunked"])
def test_mamba2_train_matches_stepwise_decode(mixer, S):
    """The parallel form (one chunk below CHUNK, two chunks at 2 CHUNK)
    equals the per-token recurrence the serving stack runs."""
    _, cfg, _, p = mixer
    x = torch.randn(1, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(S)) * 0.3
    torch.testing.assert_close(PM2.mamba2_apply(p, x, cfg),
                               _stepwise(p, x, cfg), rtol=2e-3, atol=2e-3)


def test_segsum_backward_has_no_nan(mixer):
    """The mask comes before the exp: large positive differences in the
    upper triangle leave the gradient finite."""
    _, cfg, _, p = mixer
    ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = torch.randn(1, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)) * 3.0
    x.requires_grad_(True)
    PM2.mamba2_apply(ps, x, cfg).square().sum().backward()
    assert bool(torch.isfinite(x.grad).all())
    assert all(bool(torch.isfinite(v.grad).all()) for v in ps.values())


@pytest.mark.parametrize("S", [1, 2])
def test_short_sequence_state_raises(mixer, S):
    """A state needs ssm_conv - 1 = 3 tokens for its conv tail: a shorter
    sequence raises (the reference slices a tail of fewer rows)."""
    _, cfg, _, p = mixer
    x = torch.zeros(1, S, cfg.d_model)
    with pytest.raises(ValueError, match="conv tail"):
        PM2.mamba2_apply(p, x, cfg, return_state=True)
    assert PM2.mamba2_apply(p, x, cfg).shape == x.shape


def test_make_ssm_state_defaults_to_the_card():
    cfg = get_config(ARCH, smoke=True)
    if torch.cuda.is_available():
        assert PM2.make_ssm_state(cfg, 1)["h"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PM2.make_ssm_state(cfg, 1)
