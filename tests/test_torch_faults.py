"""Fault injection in the port, held against the JAX package on the CPU:
the fault models and their registry, the neutral reduction, equal Plans
(the FAULTY column of the sampling grid) with equal fault contracts, equal
FaultTraces for a seed (frozen and adaptive deadlines, with sampling), the
faults benchmark's regime run in both packages, and obs on against off."""
import dataclasses
import json
import os

import numpy as np
import pytest

import repro.api as R
import repro.faults as RF
import repro_torch.api as P
import repro_torch.faults as PF
from repro_torch import obs
from repro_torch.core.genqsgd import GenQSGDConfig
from repro_torch.faults import (EdgeFaults, FaultDriver, FaultModel,
                                FaultSpec, FaultTrace, NoFaults, fault_names,
                                get_faults)
from repro_torch.sampling import draw_cohort
from tests.test_torch_sampling import (N, _norm, _quad_tasks, hot,
                                       same_report)
from tests.test_torch_slice import _equal_plans

pytestmark = pytest.mark.faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def faulty(mod, **kw):
    """A genuinely faulty fleet: stragglers + 2-round crashes + corruption
    (``tests/unit/test_faults.py``'s FAULTY)."""
    return mod.edge_faults(straggler_prob=0.3, straggler_factor=4.0,
                           crash_prob=0.1, crash_rounds=2, corrupt_prob=0.05,
                           deadline_slack=1.5, **kw)


def _spec(mod, model, t=1.0):
    """A FaultSpec over homogeneous worker times (FaultDriver tests)."""
    wt = np.full(N, float(t))
    deadline = model.deadline_slack * float(t)
    return mod.FaultSpec(model=model, worker_times=tuple(wt),
                         deadline=float(deadline),
                         deliver_p=tuple(model.deliver_prob(wt, deadline)))


def test_registry_contents():
    assert set(fault_names()) >= {"none", "edge"}
    assert set(fault_names()) >= set(RF.fault_names())
    assert get_faults("none").is_neutral(N)
    assert isinstance(get_faults("edge"), FaultModel)
    assert get_faults("edge").is_neutral(N)    # all-zero until configured
    with pytest.raises(ValueError, match="unknown fault model"):
        get_faults("nope")


@pytest.mark.parametrize("neutral", [NoFaults(), P.edge_faults()])
def test_neutral_plan_and_runreport_identical(neutral):
    """A neutral fault model is no fault model: the same Plan (faults
    None) and the same report."""
    assert neutral.is_neutral(N)
    base = hot(P, dim=16).optimize()
    neut = hot(P, faults=neutral, dim=16).optimize()
    assert neut == base and neut.faults is None
    task = P.QuadraticTask(dim=16, device="cpu")
    r_base = hot(P, dim=16).run(base, task=task, seed=7, max_rounds=4,
                                device="cpu")
    r_neut = hot(P, faults=neutral, dim=16).run(neut, task=task, seed=7,
                                                max_rounds=4, device="cpu")
    assert _norm(r_base) == _norm(r_neut)
    assert r_neut.fault_trace is None


@pytest.mark.parametrize("m", ["C", "E", "D"])
def test_faulty_plans_equal_reference(m):
    """The FAULTY column of the sampling grid: equal Plans, fault
    contract included."""
    rscn, pscn = hot(R, m, faults=faulty(R)), hot(P, m, faults=faulty(P))
    rp, pp = rscn.optimize(), pscn.optimize()
    _equal_plans(rp, pp)
    assert pp.describe() == rp.describe()
    spec = pp.faults
    assert isinstance(spec, FaultSpec) and spec.N == N
    sys = pscn._priced_system
    wt = pp.B * sys.comp_time_coeff * np.asarray(pp.Kn) + sys.M_sn / sys.rn
    assert np.array_equal(spec.worker_times, wt)
    assert "faults=edge" in pp.describe()
    assert pp.to_genqsgd_config(seed=0).faults is spec


def test_validation_errors():
    with pytest.raises(ValueError, match="straggler_prob"):
        hot(P, faults=P.edge_faults(straggler_prob=1.2))
    with pytest.raises(ValueError, match="deadline_slack"):
        hot(P, faults=P.edge_faults(deadline_slack=0.5))
    with pytest.raises(ValueError, match="straggler_factor"):
        hot(P, faults=P.edge_faults(straggler_prob=0.1,
                                    straggler_factor=0.5))
    with pytest.raises(ValueError, match="crash_rounds"):
        P.edge_faults(crash_prob=0.1, crash_rounds=0).validate(N)
    with pytest.raises(ValueError, match="freq_margin"):
        hot(P, faults=P.edge_faults(freq_margin=1.0))
    with pytest.raises(ValueError, match="delivery probabilities"):
        FaultSpec(model=EdgeFaults(), worker_times=(1.0,) * N,
                  deadline=1.0, deliver_p=(0.0,) * N)
    with pytest.raises(ValueError, match="workers"):
        FaultDriver(_spec(PF, EdgeFaults()), N + 1)
    with pytest.raises(ValueError, match="'frozen' or 'adaptive'"):
        P.edge_faults(deadline="bogus").validate(N)
    with pytest.raises(ValueError, match="finite deadline_slack"):
        P.edge_faults(deadline="adaptive").validate(N)
    with pytest.raises(ValueError, match="ema_alpha"):
        P.edge_faults(deadline="adaptive", deadline_slack=1.5,
                      ema_alpha=0.0).validate(N)
    cfg = dict(K0=1, Kn=(1,) * N, B=1, step_rule=P.ConstantRule(0.01))
    with pytest.raises(TypeError, match="FaultSpec"):
        GenQSGDConfig(faults=object(), **cfg)
    spec = _spec(PF, P.edge_faults(crash_prob=0.1))
    with pytest.raises(ValueError, match="workers"):
        GenQSGDConfig(faults=spec, **{**cfg, "Kn": (1,) * (N + 1)})
    assert GenQSGDConfig(faults=spec, **cfg).faults is spec


@pytest.mark.parametrize("mode", ["frozen", "adaptive"])
def test_fault_traces_equal_reference(mode):
    """FaultDriver over 60 sampled rounds in both packages, from the same
    seed: equal FaultTraces and HT weights; the adaptive deadline's round 0
    is the frozen one bitwise, and tau then moves."""
    kw = {} if mode == "frozen" else {"deadline": "adaptive",
                                      "ema_alpha": 0.3}
    wt = (0.5, 0.8, 1.0, 2.0)

    def drive(mod):
        fm = faulty(mod, **kw)
        dl = fm.deadline_slack * max(wt)
        spec = mod.FaultSpec(model=fm, worker_times=wt, deadline=dl,
                             deliver_p=tuple(fm.deliver_prob(wt, dl)))
        drv = mod.FaultDriver(spec, N, agg_weights=(0.1, 0.2, 0.3, 0.4))
        crng, frng = np.random.default_rng(123), mod.fault_rng(123)
        us = []
        for k in range(60):
            idx, pi = draw_cohort(crng, N, 3)
            us.append(drv.step(frng, k, idx, pi))
        return drv.trace(), np.stack(us)

    (rt, ru), (pt, pu) = drive(RF), drive(PF)
    assert isinstance(pt, FaultTrace) and len(pt) == 60
    assert dataclasses.asdict(pt) == dataclasses.asdict(rt)
    assert np.array_equal(pu, ru)
    taus = {r.deadline for r in pt.records}
    if mode == "adaptive":
        assert pt.records[0].deadline == 1.5 * max(wt) and len(taus) > 5
    else:
        assert taus == {1.5 * max(wt)}
    assert pt.rounds_degraded > 0


def _bench_scenario(mod, slack):
    return mod.Scenario(system=mod.EdgeSystem.paper_sec_vii(dim=1024, N=N),
                        consts=mod.MLProblemConstants(
                            L=0.084, sigma=33.18, G=33.63, f_gap=2.3, N=N),
                        T_max=1e6, C_max=1.0, step=mod.ConstantRule(0.01),
                        faults=mod.edge_faults(deadline_slack=slack,
                                               straggler_prob=0.3,
                                               straggler_factor=4.0))


#: ``benchmarks/faults_bench.py``: N = 4, every worker 4x slower with
#: probability 0.3, deadline-HT at slack 1.5 against blocking sync, seed 0
@pytest.mark.parametrize("discipline,slack", [("deadline", 1.5),
                                              ("blocking", float("inf"))])
def test_faults_bench_regime_equals_reference(discipline, slack):
    """The faults benchmark's regime over the Plan's whole K0 = 182 rounds
    in both packages: equal Plans, FaultTraces, comm bits, measured E/T and
    drift ledgers, realized seconds a round as ``BENCH_faults.json``
    records them (5.73 deadline-HT, 12.28 blocking), and QuadraticTask's
    err within a factor of 1.5 of the reference's at the same seed (the
    two packages draw the mini-batches and quantizer noise from different
    streams; over seeds 0-3 both land at 0.0034-0.0055)."""
    with open(os.path.join(ROOT, "BENCH_faults.json")) as f:
        bench = json.load(f)
    rscn, pscn = _bench_scenario(R, slack), _bench_scenario(P, slack)
    rplan, pplan = rscn.optimize(), pscn.optimize()
    _equal_plans(rplan, pplan)
    assert pplan.K0 == bench["rounds"] == 182
    rt, pt = _quad_tasks()
    rrep = rscn.run(rplan, task=rt, seed=0, max_rounds=pplan.K0)
    prep = pscn.run(pplan, task=pt, seed=0, max_rounds=pplan.K0,
                    device="cpu")
    same_report(rrep, prep)
    ft = prep.fault_trace
    assert len(ft) == len(prep.drift()) == 182
    assert round(ft.realized_time / 182, 6) == \
        bench[discipline]["round_s"]
    assert (ft.workers_dropped > 0) == (discipline == "deadline")
    if discipline == "deadline":
        assert ft.workers_dropped == bench["deadline"]["worker_rounds_dropped"]
        assert ft.rounds_degraded == bench["deadline"]["rounds_degraded"]
    er, ep = rrep.final_metrics["err"], prep.final_metrics["err"]
    assert er / 1.5 <= ep <= er * 1.5, (er, ep)
    assert ep < 0.01


def test_obs_on_against_off(tmp_path, monkeypatch):
    """Sampling + adaptive faults with obs on and off: the reports are
    equal apart from wall time; only the obs-on run writes its drift
    ledger, which loads back equal to ``report.drift()``, and counts its
    rounds and wire bits."""
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    scn = hot(P, sampling=P.uniform(3),
              faults=faulty(P, deadline="adaptive"), dim=16)
    plan = scn.optimize()
    task = P.QuadraticTask(dim=16, device="cpu")
    off = scn.run(plan, task=task, seed=3, max_rounds=12, device="cpu")
    assert not os.listdir(tmp_path)
    try:
        obs.enable(reset=True)
        on = scn.run(plan, task=task, seed=3, max_rounds=12, device="cpu")
        rounds = obs.REGISTRY.counter("run.rounds", backend="reference")
        bits = obs.REGISTRY.counter("run.wire_bits", backend="reference",
                                    codec="qsgd")
        assert rounds.value == 12
        ups, down = plan._up_down(dim=16)
        want = sum(sum(ups[i] for i in set(r.cohort) - set(r.crashed))
                   + down for r in on.fault_trace.records)
        assert bits.value == want
    finally:
        obs.disable()
        obs.REGISTRY.reset()
        obs.TRACER.clear()
    assert _norm(on) == _norm(off)
    assert on.fault_trace == off.fault_trace and len(on.fault_trace) == 12
    assert on.drift() == off.drift()
    path = tmp_path / "ledger_genqsgd_reference_seed3.jsonl"
    assert sorted(os.listdir(tmp_path)) == [path.name]
    assert obs.RunLedger.load_jsonl(str(path)) == on.drift()


# ---------------------------------------------------------------------------
# the cases of tests/unit/test_faults.py on the port's own copies, on its
# N = 4 paper system (T_max 1e6, C_max 1.0)
# ---------------------------------------------------------------------------
SYS = P.EdgeSystem.paper_sec_vii(dim=64, N=N)
_CONSTS = P.MLProblemConstants(L=0.084, sigma=33.18, G=33.63, f_gap=2.3, N=N)


def _scenario(faults="none", sampling="full"):
    return P.Scenario(system=SYS, consts=_CONSTS, T_max=1e6, C_max=1.0,
                      step=P.ConstantRule(0.01), sampling=sampling,
                      faults=faults)


def test_reference_run_fault_trace_deterministic():
    scn = _scenario(faulty(P))
    plan = scn.optimize()
    task = P.QuadraticTask(dim=16, device="cpu")
    r1, r2, r3 = (scn.run(plan, task=task, seed=s, max_rounds=12,
                          device="cpu") for s in (3, 3, 4))
    assert isinstance(r1.fault_trace, FaultTrace) and len(r1.fault_trace) == 12
    assert r1.fault_trace == r2.fault_trace and _norm(r1) == _norm(r2)
    assert r3.fault_trace != r1.fault_trace          # seeds matter


def test_fault_rng_stream_is_salted():
    a = PF.fault_rng(7).random(8)
    assert not np.allclose(a, np.random.default_rng(7).random(8))
    assert np.array_equal(a, PF.fault_rng(7).random(8))
    assert np.array_equal(a, RF.fault_rng(7).random(8))


def test_crash_markov_chain_holds_down_rounds():
    """crash_rounds=R keeps a crashed worker down R consecutive rounds; the
    realized up-fraction approaches the stationary value availability()
    plans with."""
    fm = P.edge_faults(crash_prob=0.2, crash_rounds=3)
    drv = FaultDriver(_spec(PF, fm), N)
    rng = PF.fault_rng(0)
    rounds = 4000
    for r in range(rounds):
        drv.step(rng, r)
    down = np.zeros((rounds, N), bool)
    for r, rec in enumerate(drv.records):
        down[r, list(rec.crashed)] = True
    starts = down[1:] & ~down[:-1]
    for r, n in zip(*np.nonzero(starts)):
        spell = down[r + 1:r + 4, n]
        assert spell[:min(3, rounds - r - 1)].all()
    assert 1.0 - down.mean() == pytest.approx(fm._up_frac, abs=0.02)
    assert fm.availability(N)[0] == pytest.approx(fm._up_frac)


def test_deadline_excludes_stragglers_and_blocking_waits():
    fm = P.edge_faults(straggler_prob=0.4, straggler_factor=4.0,
                       deadline_slack=1.5)
    spec = _spec(PF, fm)                  # deadline 1.5, straggler arrival 4
    assert spec.deliver_p == (0.6,) * N
    drv, rng = FaultDriver(spec, N), PF.fault_rng(1)
    saw = False
    for r in range(200):
        u = drv.step(rng, r)
        rec = drv.last
        assert set(rec.delivered).isdisjoint(rec.straggled)
        assert np.all(np.flatnonzero(u) == np.asarray(rec.delivered))
        saw |= bool(rec.straggled)
        assert rec.t_round == pytest.approx(1.5 if rec.straggled else 1.0)
    assert saw
    # slack = inf: nobody is excluded and the round waits for the slowest
    drv = FaultDriver(_spec(PF, P.edge_faults(straggler_prob=0.4,
                                              straggler_factor=4.0)), N)
    rng = PF.fault_rng(1)
    for r in range(50):
        u = drv.step(rng, r)
        rec = drv.last
        assert rec.delivered == rec.cohort and not rec.n_dropped
        assert rec.t_round == rec.t_blocking
        assert np.allclose(u, 1.0 / N)


def test_deadline_ht_unbiased():
    """E[Σ u_n d_n] = Σ w_n d_n over the fault draw, alone and composed
    with the cohort draw."""
    d = np.array([3.0, -1.0, 2.0, 5.0])
    w = np.array([0.1, 0.2, 0.3, 0.4])
    fm = P.edge_faults(crash_prob=0.25, corrupt_prob=0.1)
    drv, rng = FaultDriver(_spec(PF, fm), N, agg_weights=w), PF.fault_rng(2)
    assert np.allclose(drv._dp, 0.75 * 0.9)
    acc = sum(float(np.sum(drv.step(rng, r) * d)) for r in range(8000))
    assert acc / 8000 == pytest.approx(float(np.sum(w * d)), abs=0.05)
    fm = P.edge_faults(straggler_prob=0.3, straggler_factor=4.0,
                       crash_prob=0.2, deadline_slack=1.5)
    drv = FaultDriver(_spec(PF, fm), N)
    crng, frng = np.random.default_rng(0), PF.fault_rng(0)
    acc = 0.0
    for r in range(8000):
        idx, pi = draw_cohort(crng, N, 2)
        u = drv.step(frng, r, idx, pi)
        assert set(np.flatnonzero(u)) <= set(int(i) for i in idx)
        acc += float(np.sum(u * d))
    assert acc / 8000 == pytest.approx(float(np.mean(d)), abs=0.08)
    assert all(len(rec.cohort) == 2 for rec in drv.records)


def test_checksum_and_corrupt_workers():
    rng = np.random.default_rng(0)
    payload = rng.standard_normal(256).astype(np.float32)
    ref = PF.payload_checksum(payload)
    assert ref == RF.payload_checksum(payload)
    assert ref == PF.payload_checksum(payload.copy())
    for _ in range(20):
        assert PF.payload_checksum(PF.flip_bits(payload, rng)) != ref
    assert PF.payload_checksum(payload) == ref       # input untouched
    assert PF.payload_checksum(PF.flip_bits(payload, rng, n_flips=8)) != ref
    drv = FaultDriver(_spec(PF, P.edge_faults(corrupt_prob=0.3)), N)
    frng = PF.fault_rng(3)
    seen = 0
    for r in range(100):
        u = drv.step(frng, r)
        rec = drv.last
        seen += len(rec.corrupt)
        assert set(rec.delivered).isdisjoint(rec.corrupt)
        assert np.all(u[list(rec.corrupt)] == 0.0)
        assert rec.t_round == pytest.approx(1.0)     # a corrupt upload arrives
    assert seen > 0


def test_availability_and_margins_in_the_plan():
    """Availability a: q_eff = (q+1-a pi)/(a pi), c3 / (a pi), with and
    without a pinned cohort, as ``EdgeSystem(an=...)`` prices it;
    worst-case margins derate the time constraint only (and at zero margin
    return the same objects) and need no runtime fault contract."""
    from repro_torch.core.cost import time_cost
    fm = P.edge_faults(crash_prob=0.3)   # R = 1: availability is exact
    a = fm.availability(N)[0]
    assert a == pytest.approx(0.7)
    c0, q0 = _scenario().problem()._conv_coeffs()
    for samp, pi in (("full", 1.0), (P.uniform(S=2), 0.5)):
        cf, qf = _scenario(fm, samp).problem()._conv_coeffs()
        assert np.allclose(np.asarray(qf),
                           (np.asarray(q0) + 1.0 - a * pi) / (a * pi))
        assert cf[2] == pytest.approx(c0[2] / (a * pi))
    sys_a = dataclasses.replace(SYS, an=np.full(N, a))
    pa = dataclasses.replace(_scenario(), system=sys_a).problem()
    _, q_fm = _scenario(fm).problem()._conv_coeffs()
    assert np.array_equal(np.asarray(pa._conv_coeffs()[1]), np.asarray(q_fm))
    fm = P.edge_faults(freq_margin=0.2, rate_margin=0.2)
    assert not fm.is_neutral(N) and not fm.runtime_active(N)
    assert _scenario(fm)._fault_spec((1,) * N, 1) is None   # no driver
    sys_m = dataclasses.replace(SYS, freq_margin=0.2, rate_margin=0.2)
    K0, Kn, B = 2000, np.array([1, 2, 8, 8]), 3
    t_nom = time_cost(SYS, K0, Kn, B)
    assert time_cost(sys_m, K0, Kn, B, worst_case=True) > t_nom
    assert time_cost(sys_m, K0, Kn, B) == t_nom
    assert SYS.comp_time_coeff_wc is SYS.comp_time_coeff
    assert SYS.comm_time_wc == SYS.comm_time
    assert sys_m.comm_time_wc > sys_m.comm_time


def test_adaptive_deadline():
    """Frozen is the default and adaptive shares the model's signature;
    the EMA replays by hand (censored round times, floored at max_n t_n);
    a Scenario run varies tau, a frozen one does not."""
    adaptive = faulty(P, deadline="adaptive", ema_alpha=0.3)
    assert P.edge_faults(deadline_slack=1.5).deadline == "frozen"
    assert adaptive.signature(N) == faulty(P).signature(N)
    wt = np.array([0.5, 0.8, 1.0, 2.0])
    slack = adaptive.deadline_slack
    deadline = slack * float(wt.max())
    spec = FaultSpec(model=adaptive, worker_times=tuple(wt),
                     deadline=float(deadline),
                     deliver_p=tuple(adaptive.deliver_prob(wt, deadline)))
    drv, rng = FaultDriver(spec, N), PF.fault_rng(123)
    for k in range(60):
        drv.step(rng, k)
    ema, taus = deadline / slack, set()
    for rec in drv.records:
        assert rec.deadline == max(slack * ema, float(wt.max()))
        assert rec.t_round <= rec.deadline
        ema += adaptive.ema_alpha * (rec.t_round - ema)
        taus.add(rec.deadline)
    assert len(taus) > 5
    task = P.QuadraticTask(dim=16, device="cpu")
    for fm, n_tau in ((adaptive, None), (faulty(P), 1)):
        scn = _scenario(fm)
        rep = scn.run(scn.optimize(), task=task, seed=7, max_rounds=25,
                      device="cpu")
        taus = {r.deadline for r in rep.fault_trace.records}
        assert len(taus) > 1 if n_tau is None else len(taus) == n_tau
