"""The algorithm families on the port's closed loop, at full width
(D = 101,770, N = 10, s0 = sn = 2^14): Plans of pm / fa / pr / gqfedwavg,
one GQFedWAvg round with the JAX package's draws injected, and a short
GQFedWAvg run, each held against the JAX package on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EdgeSystem as REdge
from repro.api import MNISTTask as RTask
from repro.api import Plan as RPlan
from repro.api import Scenario as RScenario
from repro.core.convergence import MLProblemConstants as RConsts
from repro.core.genqsgd import GenQSGD as RGenQSGD
from repro.core.genqsgd import flatten_like as r_flatten
from repro.core.step_rules import ConstantRule as RConstant
from repro_torch.api import EdgeSystem, MNISTTask, Plan, Scenario
from repro_torch.compress import make_codec
from repro_torch.core.convergence import MLProblemConstants
from repro_torch.core.genqsgd import GenQSGD, flatten_like
from repro_torch.core.step_rules import ConstantRule
from repro_torch.families import GQFedWAvgFamily
from repro_torch.models.mlp import params_from_jax
from tests.test_torch_slice import (CONSTS, GAMMA, QUICK, N, S, _equal_plans,
                                    _jax_draws)

#: GQFedWAvg with unequal aggregation weights and heavy momentum: the
#: hooks a uniform, beta = 0.5 family would leave untested
SMOKE = GQFedWAvgFamily(key="gqfedwavg-smoke", momentum=0.9,
                        weights=(4, 4, 2, 2, 1, 1, 1, 1, 1, 1))


def _hooks(fam):
    return dict(family=fam.key, codec_kind=fam.codec_kind,
                agg_weights=fam.agg_weights(N), momentum=fam.momentum,
                normalize=fam.normalize)


ROUNDS = 40


@pytest.fixture(scope="module")
def tasks():
    return RTask(), MNISTTask(device="cpu")


@pytest.fixture(scope="module")
def ref_alg(tasks):
    """The JAX reference runtime for the SMOKE family, capped at ROUNDS:
    one compiled round shared by the round test and the run test."""
    rtask, _ = tasks
    cfg = RPlan.manual(step_rule=RConstant(GAMMA), **QUICK, **_hooks(SMOKE)) \
        .to_genqsgd_config(max_K0=ROUNDS)
    return RGenQSGD(rtask.loss, rtask.sample, cfg), rtask.make_data(N)


@pytest.mark.parametrize("family,m", [
    ("pm", "C"), ("pm", "J"), ("fa", "C"), ("pr", "C"), ("pr", "J"),
    ("gqfedwavg", "C"), ("gqfedwavg", "J")])
def test_family_plans_equal(family, m):
    """Each family's optimizer is the same float64 NumPy in the same
    order: the Plans are equal field for field, priced at the family's
    codec (gqfedwavg: rotated, padded to 2^17 plus the seed).  pm, fa and
    pr differ only in their varmaps on genqsgd's solver, so fa's joint (J)
    solve, ~10 s in each package, adds no path that pm/J and pr/J leave
    untested."""
    kw = dict(T_max=1e5, C_max=0.25, family=family)
    r = RScenario(REdge.paper_sec_vii(), RConsts(**CONSTS),
                  step=RConstant(1e-3) if m == "C" else None, **kw)
    p = Scenario(EdgeSystem.paper_sec_vii(), MLProblemConstants(**CONSTS),
                 step=ConstantRule(1e-3) if m == "C" else None, **kw)
    rp, pp = r.optimize(), p.optimize()
    assert pp.objective.value == m and pp.family == family
    _equal_plans(rp, pp)
    assert pp.round_bits() == rp.round_bits()
    assert pp.describe() == rp.describe()
    if family == "gqfedwavg":
        assert pp.codec_kind == "rotated"
        # norm word + 2^17 levels of 1 + 15 bits ("packed") + the seed
        assert p._priced_system.M_s0 == 32.0 + 131072 * 16.0 + 32.0


def test_gqfedwavg_round_matches_reference(tasks, ref_alg):
    """One round of GQFedWAvg with unequal weights and beta = 0.9, the JAX
    draws re-derived at the padded message length d' = 2^17.  Gradients
    differ by float32 rounding between XLA and PyTorch; where that moves a
    rotated value across a level boundary, the unrotated result moves by
    a level spread over all d' coordinates.  So: every coordinate within
    two server levels, and at most 1e-3 of them off by more than 1e-6."""
    rtask, ptask = tasks
    ralg, rdata = ref_alg
    pcfg = Plan.manual(step_rule=ConstantRule(GAMMA), **QUICK,
                       **_hooks(SMOKE)).to_genqsgd_config()
    palg = GenQSGD(ptask.loss, ptask.make_data(N), ptask.shapes, pcfg)
    assert palg.msg_dim == 2**17
    p0 = rtask.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    x_r, m_r = ralg._round(p0, rdata, key, jnp.float32(GAMMA))
    x_r = np.asarray(r_flatten(x_r))
    x0 = flatten_like(params_from_jax({k: np.asarray(v)
                                       for k, v in p0.items()}, device="cpu"))
    draws = _jax_draws(key, palg.n_local, pcfg.K_max, pcfg.B, palg.msg_dim)
    x_p, m_p = palg.round(x0, *draws, GAMMA)
    np.testing.assert_allclose(float(m_p["delta_norm"]),
                               float(m_r["delta_norm"]), rtol=1e-5)
    level = GAMMA * float(m_r["delta_norm"]) / S
    diff = np.abs(x_p.numpy() - x_r)
    assert diff.max() <= 2 * level + 1e-7, (diff.max(), level)
    assert (diff > 1e-6).mean() <= 1e-3
    np.testing.assert_allclose(float(m_p["update_norm"]),
                               float(m_r["update_norm"]), rtol=1e-3)


def test_gqfedwavg_short_run_matches_reference_spread(tasks, ref_alg):
    """A short run of the SMOKE variant through ``Scenario.run`` (a family
    object the registry does not hold): comm bits exactly
    rounds * (sum M_sn + M_s0) at the rotated pricing, test_acc /
    eval_loss within the spread of the JAX package over three seeds (twice
    their range plus 0.02, as the GenQSGD run's test), and an eval loss
    below the initial model's by more than twice that range, so a run that
    leaves the model unchanged fails."""
    rtask, ptask = tasks
    ralg, rdata = ref_alg
    pscn = Scenario(EdgeSystem.paper_sec_vii(), MLProblemConstants(**CONSTS),
                    T_max=1e5, C_max=0.25, family=SMOKE)
    pplan = Plan.manual(step_rule=ConstantRule(GAMMA), **QUICK,
                        **_hooks(SMOKE))
    ref = [rtask.metrics(ralg.run(rtask.init_params(jax.random.PRNGKey(s)),
                                  rdata, jax.random.PRNGKey(s + 1))[0])
           for s in range(3)]
    rep = pscn.run(pplan, task=ptask, max_rounds=ROUNDS, device="cpu")
    sysp = pscn._priced_system
    assert sysp.codec_kind == "rotated"
    msg = make_codec(S, kind="rotated").wire_bits(rep.model_dim)
    assert rep.comm_bits == ROUNDS * (float(np.sum(sysp.M_sn)) + sysp.M_s0)
    assert rep.comm_bits == ROUNDS * (N + 1) * msg
    for name in ("test_acc", "eval_loss"):
        vals = np.array([r[name] for r in ref])
        tol = 2 * np.ptp(vals) + 0.02
        assert abs(rep.final_metrics[name] - vals.mean()) <= tol, \
            (name, rep.final_metrics[name], vals)
    # Scenario.run's initial model (seed 0)
    x0 = flatten_like(ptask.init_params(torch.Generator().manual_seed(0)))
    loss0 = ptask.metrics(x0)["eval_loss"]
    spread = np.ptp([r["eval_loss"] for r in ref])
    assert loss0 - rep.final_metrics["eval_loss"] > 2 * spread, \
        (loss0, rep.final_metrics["eval_loss"], spread)


def test_gqfedwavg_config_validates_hooks():
    """The runtime config carries the family hooks with the JAX package's
    validation: weights positive and one per worker, beta in [0, 1)."""
    from repro_torch.core.genqsgd import GenQSGDConfig
    base = dict(K0=1, Kn=(1,) * N, B=1, step_rule=ConstantRule(0.1))
    cfg = GenQSGDConfig(**base, agg_weights=(1,) * N, momentum=0.9,
                        normalize=True, codec_kind="rotated")
    assert cfg.agg_weights == (1.0,) * N
    for bad in (dict(agg_weights=(1.0,) * (N - 1)),
                dict(agg_weights=(0.0,) + (1.0,) * (N - 1)),
                dict(momentum=1.0)):
        with pytest.raises(ValueError):
            GenQSGDConfig(**base, **bad)
    assert dataclasses.replace(cfg, momentum=0.0).momentum == 0.0
