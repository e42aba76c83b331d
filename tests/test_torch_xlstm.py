"""The xLSTM blocks of repro_torch (``models/xlstm.py``: mLSTM and sLSTM)
against the JAX package's (``repro/models/xlstm.py``) on the CPU, at
xlstm-1.3b's smoke config (d_model 256, 4 heads; mLSTM heads of 128, sLSTM
heads of 64).

Weights are the JAX package's ``mlstm_init``/``slstm_init`` carried
across; inputs come from numpy seeds.  S in {64, 200, 512}: the quadratic
form below and at 512 (called directly), and the chunked form at 512 (two
chunks of 256, which ``mlstm_apply`` picks).  Tolerances:
- f32 forward (``mlstm_apply``, ``slstm_apply``, each decode step's y)
  within 1e-5 (absolute and relative) of the reference's: the same f32
  algebra contracted in another order.  A quadratic form over more than
  one chunk of tokens (S = 512 called directly, and the LM at a 300-token
  prompt) is held within 1e-4: the two packages' log-sigmoids of the
  forget gates differ by an ulp on ~70 % of the entries (their exp and
  log1p), and the decays exp(F_i - F_j) carry the cumulative sums of
  those differences (F 6.1e-5 apart at |F| = 382, S = 512), which moves
  y by up to 2.1e-5 there (measured) and the LM's logits by 3.2e-5;
- the returned states within 1e-4 relative and 1e-5 absolute.  The
  quadratic form's state is computed in closed form (the chunked form's
  end-of-chunk update over one chunk of S), the reference's by running
  the recurrence over the sequence: the same function up to rounding
  (measured at most 1.6e-5 absolute, on m at S = 512, |m| <= 1.2);
- decode from each package's own prefill state: y and the state within
  the same tolerances at every step, and at the LM level the next decode
  steps' greedy tokens equal.  There the states are held normwise within
  1e-4 (measured at most 2.0e-5, the sLSTM layer's n): the sLSTM
  recurrence runs 300 steps on the mLSTM layer's output, which the
  log-sigmoid drift above moves;
- the ports of ``tests/integration/test_recurrent_consistency.py``'s three
  xLSTM tests keep their tolerances (chunked against quadratic within
  rtol 1e-3, atol 1e-4; the sLSTM scan against its stepwise decode within
  rtol 1e-4, atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as RLM
from repro.models import xlstm as RX
from repro.models.registry import get_config as r_get_config
from repro_torch.models import lm as PLM
from repro_torch.models import xlstm as PX
from repro_torch.models.registry import get_config

ARCH = "xlstm-1.3b"
TOL = 1e-5
LONG_TOL = 1e-4     # a quadratic span above one chunk (see above)
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
_R_QUAD = jax.jit(lambda p, x, cfg: RX._mlstm_quadratic(p, x, cfg, True),
                  static_argnums=2)
_R_CHUNK = jax.jit(lambda p, x, cfg: RX._mlstm_chunked(p, x, cfg, True),
                   static_argnums=2)
_R_MDEC = jax.jit(RX.mlstm_decode, static_argnums=2)
_R_SAPPLY = jax.jit(lambda p, x, cfg: RX.slstm_apply(p, x, cfg, True),
                    static_argnums=2)
_R_SDEC = jax.jit(RX.slstm_decode, static_argnums=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _params(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def blocks():
    rcfg = r_get_config(ARCH, smoke=True)
    rm = jax.jit(RX.mlstm_init, static_argnums=1)(jax.random.PRNGKey(0), rcfg)
    rs = jax.jit(RX.slstm_init, static_argnums=1)(jax.random.PRNGKey(1), rcfg)
    return rcfg, get_config(ARCH, smoke=True), rm, _params(rm), rs, \
        _params(rs)


def _x(cfg, B, S, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def _assert_state(pst, rst):
    assert sorted(pst) == sorted(rst)
    for k, leaf in pst.items():
        assert leaf.dtype == torch.float32 and leaf.shape == rst[k].shape
        torch.testing.assert_close(leaf, _t(rst[k]), rtol=STATE_RTOL,
                                   atol=STATE_ATOL)


@pytest.mark.parametrize("form,S", [("quadratic", 64), ("quadratic", 200),
                                    ("quadratic", 512), ("chunked", 512)])
def test_mlstm_forms_match_repro(blocks, form, S):
    rcfg, pcfg, rp, pp, _, _ = blocks
    x = _x(rcfg, 2, S, S)
    ref = _R_QUAD if form == "quadratic" else _R_CHUNK
    port = PX._mlstm_quadratic if form == "quadratic" else PX._mlstm_chunked
    ry, rst = ref(rp, jnp.asarray(x), rcfg)
    py, pst = port(pp, torch.from_numpy(x), pcfg, True)
    tol = LONG_TOL if form == "quadratic" and S > PX.MLSTM_CHUNK else TOL
    torch.testing.assert_close(py, _t(ry), rtol=tol, atol=tol)
    _assert_state(pst, rst)
    # without the state: the same y
    assert torch.equal(port(pp, torch.from_numpy(x), pcfg), py)


@pytest.mark.parametrize("S", [200, 512])
def test_mlstm_apply_picks_the_reference_form(blocks, S):
    """``mlstm_apply`` runs the chunked form at S = 512 (a multiple of 256
    above one chunk) and the quadratic one at 200, as the reference."""
    rcfg, pcfg, rp, pp, _, _ = blocks
    x = torch.from_numpy(_x(rcfg, 1, S, 7))
    form = PX._mlstm_chunked if S == 512 else PX._mlstm_quadratic
    assert torch.equal(PX.mlstm_apply(pp, x, pcfg), form(pp, x, pcfg))
    ry = RX.mlstm_apply(rp, jnp.asarray(x.numpy()), rcfg)
    torch.testing.assert_close(PX.mlstm_apply(pp, x, pcfg), _t(ry),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [64, 512])
def test_mlstm_decode_matches_repro(blocks, S):
    """Four decode steps from each package's own prefill state (closed
    form at 64, the chunked carry at 512), updated in place."""
    rcfg, pcfg, rp, pp, _, _ = blocks
    x = _x(rcfg, 2, S + 4, 100 + S)
    _, rst = RX.mlstm_apply(rp, jnp.asarray(x[:, :S]), rcfg,
                            return_state=True)
    _, pst = PX.mlstm_apply(pp, torch.from_numpy(x[:, :S]), pcfg,
                            return_state=True)
    for t in range(S, S + 4):
        ry, rst = _R_MDEC(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rst)
        py, out = PX.mlstm_decode(pp, torch.from_numpy(x[:, t:t + 1]),
                                  pcfg, pst)
        assert out is pst
        torch.testing.assert_close(py, _t(ry), rtol=TOL, atol=TOL)
        _assert_state(pst, rst)


def test_mlstm_decode_from_an_empty_state_matches_repro(blocks):
    rcfg, pcfg, rp, pp, _, _ = blocks
    x = _x(rcfg, 3, 6, 5)
    rst = RX.make_mlstm_state(rcfg, 3)
    pst = PX.make_mlstm_state(pcfg, 3, device="cpu")
    _assert_state(pst, rst)
    for t in range(6):
        ry, rst = _R_MDEC(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rst)
        py, _ = PX.mlstm_decode(pp, torch.from_numpy(x[:, t:t + 1]), pcfg,
                                pst)
        torch.testing.assert_close(py, _t(ry), rtol=TOL, atol=TOL)
    _assert_state(pst, rst)


@pytest.mark.parametrize("S", [1, 40])
def test_slstm_apply_matches_repro(blocks, S):
    rcfg, pcfg, _, _, rs, ps = blocks
    x = _x(rcfg, 2, S, 30 + S)
    ry, rst = _R_SAPPLY(rs, jnp.asarray(x), rcfg)
    py, pst = PX.slstm_apply(ps, torch.from_numpy(x), pcfg,
                             return_state=True)
    torch.testing.assert_close(py, _t(ry), rtol=TOL, atol=TOL)
    _assert_state(pst, rst)


def test_slstm_decode_matches_repro(blocks):
    """Five steps from each package's own state after 24 tokens."""
    rcfg, pcfg, _, _, rs, ps = blocks
    x = _x(rcfg, 2, 29, 8)
    _, rst = _R_SAPPLY(rs, jnp.asarray(x[:, :24]), rcfg)
    _, pst = PX.slstm_apply(ps, torch.from_numpy(x[:, :24]), pcfg,
                            return_state=True)
    for t in range(24, 29):
        ry, rst = _R_SDEC(rs, jnp.asarray(x[:, t:t + 1]), rcfg, rst)
        py, out = PX.slstm_decode(ps, torch.from_numpy(x[:, t:t + 1]), pcfg,
                                  pst)
        assert out is pst
        torch.testing.assert_close(py, _t(ry), rtol=TOL, atol=TOL)
        _assert_state(pst, rst)


def test_decode_takes_one_token(blocks):
    _, cfg, _, pp, _, ps = blocks
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(ValueError, match="one token"):
        PX.mlstm_decode(pp, x, cfg, PX.make_mlstm_state(cfg, 1, "cpu"))
    with pytest.raises(ValueError, match="one token"):
        PX.slstm_decode(ps, x, cfg, PX.make_slstm_state(cfg, 1, "cpu"))


def _assert_states_normwise(pcaches, rcaches):
    assert len(pcaches) == len(rcaches)
    for pst, rst in zip(pcaches, rcaches):
        assert sorted(pst) == sorted(rst)
        for k, leaf in pst.items():
            assert leaf.dtype == torch.float32 and leaf.shape == rst[k].shape
            ref = np.asarray(rst[k])
            gap = np.linalg.norm(leaf.numpy() - ref) / np.linalg.norm(ref)
            assert gap <= LONG_TOL, (k, gap)


def test_lm_prefill_state_then_decode_tokens_match_repro():
    """xlstm-smoke (one mLSTM and one sLSTM layer) at a 300-token prompt
    (the quadratic form: its state in closed form, the reference's by the
    recurrence): the prefill logits within 1e-4 and the states normwise
    within 1e-4, then six greedy decode steps with logits within 1e-4 and
    tokens equal."""
    rcfg = r_get_config(ARCH, smoke=True)
    pcfg = get_config(ARCH, smoke=True)
    rparams = jax.jit(RLM.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), rcfg)
    pparams = PLM.params_from_jax(jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    toks = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 300))
    rl, rc = jax.jit(lambda p, t: RLM.prefill(p, rcfg, {"tokens": t}))(
        rparams, jnp.asarray(toks.astype(np.int32)))
    pl, pc = PLM.prefill(pparams, pcfg, {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(pl, _t(rl), rtol=LONG_TOL, atol=LONG_TOL)
    _assert_states_normwise(pc, rc)
    rdec = jax.jit(lambda p, t, c, po: RLM.decode_step(p, rcfg, t, c, po))
    for i in range(6):
        tok = np.asarray(jnp.argmax(rl, -1), np.int32)[:, None]
        assert np.array_equal(tok[:, 0], pl.argmax(-1).numpy())
        pos = np.full((2, 1), 300 + i, np.int32)
        rl, rc = rdec(rparams, jnp.asarray(tok), rc, jnp.asarray(pos))
        pl, pc = PLM.decode_step(pparams, pcfg, torch.from_numpy(tok), pc,
                                 torch.from_numpy(pos))
        torch.testing.assert_close(pl, _t(rl), rtol=LONG_TOL, atol=LONG_TOL)
    _assert_states_normwise(pc, rc)


# ---------------------------------------------------------------------------
# ports of tests/integration/test_recurrent_consistency.py's xLSTM tests
# ---------------------------------------------------------------------------
def _randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def test_mlstm_chunked_matches_quadratic_and_recurrent(blocks):
    _, cfg, _, p, _, _ = blocks
    x = _randn(2, 512, cfg.d_model, seed=0) * 0.5   # chunked path
    torch.testing.assert_close(PX._mlstm_chunked(p, x, cfg),
                               PX._mlstm_quadratic(p, x, cfg),
                               rtol=1e-3, atol=1e-4)


def test_mlstm_prefill_state_matches_decode(blocks):
    """The state handed off by the chunked prefill continues as the
    quadratic form's (closed-form) state does."""
    _, cfg, _, p, _, _ = blocks
    x = _randn(1, 513, cfg.d_model, seed=1) * 0.5
    _, st_chunk = PX.mlstm_apply(p, x[:, :512], cfg, return_state=True)
    y1, _ = PX.mlstm_decode(p, x[:, 512:], cfg, st_chunk)
    _, st_quad = PX._mlstm_quadratic(p, x[:, :512], cfg, return_state=True)
    y2, _ = PX.mlstm_decode(p, x[:, 512:], cfg, st_quad)
    torch.testing.assert_close(y1, y2, rtol=1e-3, atol=1e-4)


def test_slstm_train_matches_stepwise(blocks):
    _, cfg, _, _, _, p = blocks
    x = _randn(2, 16, cfg.d_model, seed=4) * 0.5
    y_train, st_train = PX.slstm_apply(p, x, cfg, return_state=True)
    st = PX.make_slstm_state(cfg, 2, device="cpu")
    y_dec = torch.cat([PX.slstm_decode(p, x[:, t:t + 1], cfg, st)[0]
                       for t in range(16)], dim=1)
    torch.testing.assert_close(y_train, y_dec, rtol=1e-4, atol=1e-5)
    for k in st_train:
        torch.testing.assert_close(st_train[k], st[k], rtol=1e-4, atol=1e-5)


def test_states_default_to_the_card():
    cfg = get_config(ARCH, smoke=True)
    for make in (PX.make_mlstm_state, PX.make_slstm_state):
        if torch.cuda.is_available():
            assert make(cfg, 1)["m"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make(cfg, 1)
