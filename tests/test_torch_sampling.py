"""Client sampling in the port, held against the JAX package on the CPU:
the participation models and their registry, equal Plans over an (m, model)
grid on the sampling-wins system (with the N = 4 anchor), equal cohort
traces and reports for a seed, the systematic PPS draw and the
Horvitz-Thompson weights, one injected-draw sampled round at full width,
QuadraticTask, and the API registries."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro.sampling as RS
import repro_torch.api as P
from repro.core.genqsgd import GenQSGD as RGenQSGD
from repro.core.genqsgd import flatten_like as r_flatten
from repro.data.federated import sample_minibatch
from repro.models import mlp as r_mlp
from repro_torch.core.genqsgd import GenQSGD, GenQSGDConfig, flatten_like
from repro_torch.models.mlp import params_from_jax
from repro_torch.sampling import (SamplingModel, check_probs, cohort_weights,
                                  draw_cohort, draw_cohort_weights,
                                  get_sampling, sampling_names)
from tests.test_torch_slice import GAMMA, QUICK, _equal_plans, _jax_draws
from tests.test_torch_slice import N as N_WIDE
from tests.test_torch_slice import S as S_WIDE

pytestmark = pytest.mark.sampling

N = 4
P_IMP = (0.4, 0.3, 0.2, 0.1)
_CONSTS = dict(L=0.084, sigma=33.18, G=33.63, f_gap=2.3, N=N)
_STEP = {"C": lambda m: m.ConstantRule(3e-4),
         "E": lambda m: m.ExponentialRule(0.05, 0.9995),
         "D": lambda m: m.DiminishingRule(0.02, 600.0)}
_SAMPLING = {"full": lambda m: "full", "uniform2": lambda m: m.uniform(2),
             "uniform": lambda m: m.uniform(),
             "importance2": lambda m: m.importance(P_IMP, 2)}


def hot(mod, m="C", sampling="full", faults="none", dim=1024):
    """``benchmarks/sampling_bench.py``'s sampling-wins regime (homogeneous
    workers at 10x the paper's compute energy) at N = 4 in either package
    (``mod`` is ``repro.api`` or ``repro_torch.api``)."""
    sys_ = dataclasses.replace(
        mod.EdgeSystem.paper_sec_vii(dim=dim, N=N, F_ratio=1.0),
        alphan=np.full(N, 2e-27))
    return mod.Scenario(system=sys_, consts=mod.MLProblemConstants(**_CONSTS),
                        T_max=1e7, C_max=0.25, step=_STEP[m](mod),
                        sampling=sampling, faults=faults)


def _norm(r):
    return dataclasses.replace(r, wall_time_s=0.0)


def same_report(a, b):
    """Reports of the two packages: every number the run measured, the
    traces and the drift ledger equal (wall time and the model's metrics
    aside)."""
    for f in ("backend", "rounds", "model_dim", "comm_bits", "measured_E",
              "measured_T", "round_bits_trace"):
        assert getattr(a, f) == getattr(b, f), f
    fa, fb = a.fault_trace, b.fault_trace
    assert (fa is None) == (fb is None)
    if fa is not None:
        assert dataclasses.asdict(fa) == dataclasses.asdict(fb)
    da, db = a.drift(), b.drift()
    assert [dataclasses.astuple(r) for r in da.rows] == \
        [dataclasses.astuple(r) for r in db.rows]
    assert (da.backend, da.family) == (db.backend, db.family)


# ---------------------------------------------------------------------------
# registry and validation
# ---------------------------------------------------------------------------
def test_registry_contents():
    assert set(sampling_names()) >= {"full", "uniform"}
    assert set(sampling_names()) >= set(RS.sampling_names())
    assert get_sampling("full").is_neutral(N)
    assert isinstance(get_sampling("uniform"), SamplingModel)
    assert get_sampling("uniform").free_S
    with pytest.raises(ValueError, match="unknown sampling model"):
        get_sampling("nope")


def test_validation_errors():
    with pytest.raises(ValueError, match="sum to 1"):
        P.importance((0.5, 0.2, 0.2, 0.2))
    with pytest.raises(ValueError, match="positive"):
        P.importance((1.2, -0.2, 0.0, 0.0))
    with pytest.raises(ValueError, match="outside"):
        hot(P, sampling=P.uniform(S=9))
    with pytest.raises(ValueError, match="probabilities"):
        hot(P, sampling=P.importance((0.5, 0.5)))
    with pytest.raises(ValueError, match="above 1"):
        hot(P, sampling=P.importance((0.7, 0.1, 0.1, 0.1), S=2))
    cfg = dict(K0=1, Kn=(1,) * N, B=1, step_rule=P.ConstantRule(0.01))
    with pytest.raises(ValueError, match="sampling_p"):
        GenQSGDConfig(sampling_p=(0.25,) * N, **cfg)
    with pytest.raises(ValueError, match="outside"):
        GenQSGDConfig(sampling_S=9, **cfg)
    with pytest.raises(ValueError, match="exceeds 1"):
        GenQSGDConfig(sampling_S=2, sampling_p=(0.7, 0.1, 0.1, 0.1), **cfg)
    ok = GenQSGDConfig(sampling_S=np.int64(2), sampling_p=P_IMP, **cfg)
    assert ok.sampling_S == 2 and type(ok.sampling_S) is int
    assert ok.sampling_p == check_probs(P_IMP, N)


# ---------------------------------------------------------------------------
# Plans: equal field for field, and the neutral reduction
# ---------------------------------------------------------------------------
#: the ROADMAP's anchor (m = C, hot, N = 4): free S stops at S = 2 with a
#: higher energy than pinning S = 2; full participation spends the most
ANCHOR = {"full": (None, 51030), "uniform": (2, 45053),
          "uniform2": (2, 38832)}
#: free S at m = E runs all 60 GIA iterates without converging (~30 s in
#: each package); the cell holds the first one, which runs the same code
MAX_ITER = {("E", "uniform"): 1}


@pytest.mark.parametrize("samp", list(_SAMPLING))
@pytest.mark.parametrize("m", ["C", "E", "D"])
def test_plans_equal_reference(m, samp):
    it = MAX_ITER.get((m, samp), 60)
    rp = hot(R, m, _SAMPLING[samp](R)).optimize(max_iter=it)
    pp = hot(P, m, _SAMPLING[samp](P)).optimize(max_iter=it)
    _equal_plans(rp, pp)
    assert pp.describe() == rp.describe()
    assert pp.predicted_comm_bits == rp.predicted_comm_bits
    assert pp.expected_round_bits() == rp.expected_round_bits()
    if m == "C" and samp in ANCHOR:
        S, E = ANCHOR[samp]
        assert pp.feasible and pp.cohort_S == S
        assert round(pp.predicted_E) == E


def test_neutral_plan_and_runreport_identical():
    """uniform(S=N) is full participation: the same Plan, and the same
    report from the historical (unsampled) path."""
    full = hot(P, dim=16).optimize()
    neut = hot(P, sampling=P.uniform(S=N), dim=16).optimize()
    assert neut == full                   # including sampling="full" fields
    task = P.QuadraticTask(dim=16, device="cpu")
    r_full = hot(P, dim=16).run(full, task=task, seed=7, max_rounds=4,
                                device="cpu")
    r_neut = hot(P, sampling=P.uniform(S=N), dim=16).run(
        neut, task=task, seed=7, max_rounds=4, device="cpu")
    assert _norm(r_full) == _norm(r_neut)
    assert r_neut.round_bits_trace == () and r_neut.fault_trace is None


# ---------------------------------------------------------------------------
# runtime: cohorts, reports, the draw itself
# ---------------------------------------------------------------------------
def _quad_tasks(dim=16):
    rt = R.QuadraticTask(dim=dim)
    X, T = rt.make_data(N)
    pt = P.QuadraticTask(device="cpu", data=(np.asarray(rt.true_w),
                                             np.asarray(X), np.asarray(T)))
    return rt, pt


#: the cohorts of the runs below: (sampling key, S, base probabilities)
COHORTS = {"uniform": ("uniform", 2, None),
           "importance2": ("importance", 2, P_IMP)}


@pytest.mark.parametrize("samp", list(COHORTS))
def test_sampled_run_equals_reference(samp):
    """Same Plan, same seed: the cohort trace, the realized bits, the
    modelled cost and the drift ledger are the reference's, and the model
    learns as far (the mini-batch and quantizer draws differ between the
    packages: err within a factor of 2).  The Plans are the optimized
    full-participation Plan with the cohort set on it (the grid above holds
    the optimizer)."""
    key, S, p = COHORTS[samp]
    rscn, pscn = hot(R), hot(P)
    rplan, pplan = (dataclasses.replace(scn.optimize(), sampling=key,
                                        cohort_S=S, sampling_p=p)
                    for scn in (rscn, pscn))
    _equal_plans(rplan, pplan)
    rt, pt = _quad_tasks()
    rrep = rscn.run(rplan, task=rt, seed=11, max_rounds=12)
    prep = pscn.run(pplan, task=pt, seed=11, max_rounds=12, device="cpu")
    same_report(rrep, prep)
    assert len(prep.round_bits_trace) == 12 and len(prep.drift()) == 12
    if samp == "uniform":  # homogeneous quantizers: realized == expected
        exp = pplan.expected_round_bits(dim=prep.model_dim)
        assert all(b == exp for b in prep.round_bits_trace)
        assert prep.comm_bits == 12 * exp
    er, ep = rrep.final_metrics["err"], prep.final_metrics["err"]
    assert ep < float(np.linalg.norm(np.asarray(rt.true_w)))   # from w = 0
    assert er / 2 <= ep <= er * 2, (er, ep)
    # the cohorts themselves: the two runtimes draw them from one stream
    rcfg = rplan.to_genqsgd_config(max_K0=12, seed=11)
    ralg = RGenQSGD(rt.loss, rt.sample, rcfg)
    ralg.run(rt.init_params(None), rt.make_data(N), jax.random.PRNGKey(0))
    palg = GenQSGD(pt.loss, pt.make_data(N), pt.shapes,
                   pplan.to_genqsgd_config(max_K0=12, seed=11))
    palg.run(torch.zeros(pt.dim), torch.Generator().manual_seed(0))
    assert len(palg.cohort_trace) == 12 and palg.fault_trace is None
    for a, b in zip(ralg.cohort_trace, palg.cohort_trace):
        np.testing.assert_array_equal(a, b)


def test_same_seed_runs_are_identical():
    scn = hot(P, sampling=P.uniform())
    plan = scn.optimize()
    task = P.QuadraticTask(dim=16, device="cpu")
    r1 = scn.run(plan, task=task, seed=5, max_rounds=6, device="cpu")
    r2 = scn.run(plan, task=task, seed=5, max_rounds=6, device="cpu")
    assert _norm(r1) == _norm(r2)


def test_systematic_pps_hits_inclusion_probabilities():
    p = np.array(P_IMP)
    S, trials = 2, 4000
    rng, rrng = np.random.default_rng(0), np.random.default_rng(0)
    counts = np.zeros(N)
    for _ in range(trials):
        idx, pi = draw_cohort(rng, N, S, p)
        ridx, rpi = RS.draw_cohort(rrng, N, S, p)
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_array_equal(pi, rpi)
        assert len(idx) == S and len(set(idx.tolist())) == S
        counts[idx] += 1
    assert np.allclose(counts / trials, S * p, atol=0.03)


def test_horvitz_thompson_unbiased():
    rng = np.random.default_rng(1)
    d = np.array([3.0, -1.0, 2.0, 5.0])        # per-worker "deltas"
    w = np.array([0.1, 0.2, 0.3, 0.4])         # family aggregation weights
    target = float(np.sum(w * d))
    trials = 6000
    acc = 0.0
    for _ in range(trials):
        _, u = draw_cohort_weights(rng, N, 2, p=None, agg_weights=w)
        acc += float(np.sum(u * d))
    assert acc / trials == pytest.approx(target, abs=0.05)
    idx, u = draw_cohort_weights(rng, N, 2)
    assert np.count_nonzero(u) == 2 and set(np.flatnonzero(u)) == set(idx)
    # S = N with uniform p: pi_n = 1, u_n = 1/N — the exact full mean
    idx, u = draw_cohort_weights(np.random.default_rng(0), N, N)
    assert np.array_equal(np.sort(idx), np.arange(N))
    assert np.allclose(u, 1.0 / N)
    assert np.array_equal(u, cohort_weights(idx, np.ones(N), N))


def test_sampled_round_matches_reference():
    """One sampled round at full width (D = 101,770, N = 10) with the JAX
    package's draws and an importance cohort of 5 (five workers at u = 0,
    unequal weights on the rest) injected: within the slice's round
    tolerance (every coordinate within two server levels, at most 1e-3 of
    them off by more than 1e-6).  The data are 64 seeded samples of the
    MNIST shapes a worker, the same arrays in both packages."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N_WIDE, 64, 784)).astype(np.float32)
    y = rng.integers(0, 10, (N_WIDE, 64)).astype(np.int32)
    p = np.arange(1.0, N_WIDE + 1) / np.sum(np.arange(1.0, N_WIDE + 1))
    idx, u = draw_cohort_weights(np.random.default_rng(3), N_WIDE, 5, p=p)
    assert np.count_nonzero(u) == 5 and len(set(u[u > 0])) > 1
    rcfg = R.Plan.manual(step_rule=R.ConstantRule(GAMMA), **QUICK) \
        .to_genqsgd_config()
    pcfg = P.Plan.manual(step_rule=P.ConstantRule(GAMMA), **QUICK) \
        .to_genqsgd_config()
    ralg = RGenQSGD(r_mlp.loss, sample_minibatch, rcfg)
    palg = GenQSGD(P.MNISTTask.loss, (torch.as_tensor(X),
                                      torch.as_tensor(y, dtype=torch.int64)),
                   P.MNISTTask.shapes, pcfg)
    p0 = r_mlp.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(9)
    x_r, m_r = ralg._round(p0, (jnp.asarray(X), jnp.asarray(y)), key,
                           jnp.float32(GAMMA), jnp.asarray(u, jnp.float32))
    x_r = np.asarray(r_flatten(x_r))
    x0 = flatten_like(params_from_jax({k: np.asarray(v)
                                       for k, v in p0.items()}, device="cpu"))
    draws = _jax_draws(key, palg.n_local, pcfg.K_max, pcfg.B, palg.dim)
    x_p, m_p = palg.round(x0, *draws, GAMMA,
                          torch.as_tensor(u, dtype=torch.float32))
    np.testing.assert_allclose(float(m_p["delta_norm"]),
                               float(m_r["delta_norm"]), rtol=1e-5)
    level = GAMMA * float(m_r["delta_norm"]) / S_WIDE
    diff = np.abs(x_p.numpy() - x_r)
    assert diff.max() <= 2 * level + 1e-7, (diff.max(), level)
    assert (diff > 1e-6).mean() <= 1e-3
    np.testing.assert_allclose(float(m_p["update_norm"]),
                               float(m_r["update_norm"]), rtol=1e-3)
    # u takes precedence over the mean: the unsampled round differs
    x_mean, _ = palg.round(x0, *draws, GAMMA)
    assert float((x_mean - x_p).abs().max()) > 10 * level


# ---------------------------------------------------------------------------
# QuadraticTask and the registries
# ---------------------------------------------------------------------------
def test_quadratic_task_matches_reference():
    rt, pt = _quad_tasks(dim=8)
    X, T = rt.make_data(N)
    PX, PT = pt.make_data(N)
    assert pt.shapes == {"w": (8,)} and pt.dim == 8 and pt.per_worker == 64
    w = np.random.default_rng(0).standard_normal((N, 8)).astype(np.float32)
    rl = np.asarray(jax.vmap(lambda w_, x_, t_: rt.loss({"w": w_}, (x_, t_)))(
        jnp.asarray(w), X, T))
    pl = pt.loss({"w": torch.as_tensor(w)}, (PX, PT)).numpy()
    np.testing.assert_allclose(pl, rl, rtol=1e-6)
    assert torch.equal(pt.init_params(None)["w"], torch.zeros(8))
    assert pt.metrics(torch.as_tensor(w[0]))["err"] == pytest.approx(
        rt.metrics({"w": jnp.asarray(w[0])})["err"], rel=1e-6)
    # its own data: seeded NumPy draws, the same for a seed
    a, b = P.QuadraticTask(device="cpu"), P.QuadraticTask(device="cpu")
    assert torch.equal(a.true_w, b.true_w)
    assert all(torch.equal(x, y) for x, y in zip(a.make_data(3),
                                                 b.make_data(3)))
    Xa, Ta = a.make_data(3)
    assert Xa.shape == (3, 64, 8) and Ta.shape == (3, 64)
    assert float((Ta - Xa @ a.true_w).abs().max()) < 0.1
    with pytest.raises(ValueError, match="workers"):
        pt.make_data(N + 1)


def test_registries_behave_as_reference():
    from repro.api import registries as RR
    from repro_torch.api import registries as PR
    assert set(PR.STEP_RULES) == set(RR.STEP_RULES) == {"C", "E", "D"}
    for m in ("C", "E", "D", "J"):
        a = RR.make_step_rule(m, 0.05, 0.99)
        b = PR.make_step_rule(m, 0.05, 0.99)
        assert type(a).__name__ == type(b).__name__
        assert np.array_equal(a.sequence(16), b.sequence(16))
    assert PR.family_names() == RR.family_names()
    assert list(PR.FAMILIES) == list(PR.family_names())
    assert len(PR.FAMILIES) == len(RR.FAMILIES)
    for fam in PR.family_names():
        a = RR.make_varmap(fam, N, True, 6000.0)
        b = PR.make_varmap(fam, N, True, 6000.0)
        assert repr(a) == repr(b), fam
        assert repr(PR.FAMILIES[fam](N, False, 6000.0)) == \
            repr(RR.FAMILIES[fam](N, False, 6000.0))
    with pytest.raises(KeyError):
        PR.FAMILIES["nope"]
    with pytest.raises(ValueError, match="did you mean"):
        PR.make_varmap("genqsgdd", N, True, 6000.0)
    # a legacy varmap factory registers as a GenQSGD-semantics family;
    # mutating FAMILIES directly works and warns
    legacy = PR.FAMILIES["pm"]
    try:
        PR.register_family("pm-legacy", legacy)
        fam = P.get_family("pm-legacy")
        assert fam.codec_kind == "qsgd" and fam.momentum == 0.0
        assert repr(PR.make_varmap("pm-legacy", N, True, 6000.0)) == \
            repr(PR.make_varmap("pm", N, True, 6000.0))
        with pytest.warns(DeprecationWarning, match="deprecated"):
            PR.FAMILIES["pm-legacy2"] = legacy
        assert "pm-legacy2" in PR.family_names()
        with pytest.warns(DeprecationWarning, match="deprecated"):
            del PR.FAMILIES["pm-legacy2"]
        # a family instance registers under the given name
        PR.register_family("wavg-renamed", P.GQFedWAvgFamily())
        assert P.get_family("wavg-renamed").key == "wavg-renamed"
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            for k in ("pm-legacy", "pm-legacy2", "wavg-renamed"):
                if k in PR.family_names():
                    del PR.FAMILIES[k]
    assert PR.family_names() == RR.family_names()


@pytest.mark.parametrize("name,item", [
    ("sweep_scenarios", 7), ("SweepReport", 7), ("PlanServer", 8),
    ("SpmdTask", 9), ("GenQSGDTrainer", 9)])
def test_api_names_outside_the_port_raise(name, item):
    """The JAX package's api names the port once refused are exported: the
    sweep API (item 7), PlanServer (item 8), and the SPMD task and trainer
    (item 9), each the object of its module; an unknown name still
    raises AttributeError."""
    if item == 7:
        from repro_torch.api import sweep as mod
    elif item == 8:
        from repro_torch.serve import planserver as mod
    elif name == "SpmdTask":
        from repro_torch.api import tasks as mod
    else:
        from repro_torch.train import trainer as mod
    assert getattr(P, name) is getattr(mod, name)
    assert name in P.__all__
    with pytest.raises(AttributeError):
        P.no_such_name


def test_free_S_and_plan_bits():
    """test_sampling.py's hot system (dim 64): free S picks a strict
    sub-cohort with less energy than full participation, feasible at the
    integer cohort; the Plan's expected and realized cohort bits."""
    full = hot(P, dim=64).optimize()
    scn = hot(P, sampling=P.uniform(), dim=64)
    samp = scn.optimize()
    assert samp.feasible and samp.converged
    assert samp.cohort_S is not None and samp.cohort_S < N
    assert samp.predicted_E < full.predicted_E
    assert scn.problem().feasible(samp.K0, np.asarray(samp.Kn), samp.B,
                                  S=samp.cohort_S)
    S = samp.cohort_S
    ups, down = samp._up_down()
    assert samp.expected_round_bits() == S * sum(ups) / N + down
    assert samp.cohort_round_bits(range(S)) == sum(ups[:S]) + down
    assert samp.predicted_comm_bits == samp.K0 * samp.expected_round_bits()
    assert full.expected_round_bits() == full.round_bits()
    assert full.predicted_comm_bits == full.K0 * full.round_bits()
