"""The first slice as a whole, at full width (D = 101,770, N = 10,
s0 = sn = 2^14): Plans, one injected-draw round, and a short run of the
quickstart Plan, each held against the JAX package on the CPU."""
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
import repro_torch
from repro_torch.api import EdgeSystem, MNISTTask, Plan, Scenario
from repro_torch.compress import (encode_fused, encode_rotated_fused,
                                  make_codec)
from repro_torch.core.convergence import MLProblemConstants
from repro_torch.core.genqsgd import GenQSGD, GenQSGDConfig, flatten_like
from repro_torch.core.step_rules import ConstantRule
from repro_torch.models.mlp import params_from_jax

N, S = 10, 2**14
CONSTS = dict(L=2.0, sigma=6.0, G=7.0, f_gap=2.4, N=N)
#: the README quickstart's Plan (JAX package, CPU): K0=2748 Kn=[6]*10 B=1
QUICK = dict(K0=2748, Kn=[6] * N, B=1, s0=S, sn=S, dim=101770)
GAMMA = 0.001779


@pytest.fixture(scope="module")
def tasks():
    return RTask(), MNISTTask(device="cpu")


def _equal_plans(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "step_rule":
            x, y = (type(x).__name__, x.gamma), (type(y).__name__, y.gamma)
        elif f.name == "objective":
            x, y = x.value, y.value
        elif f.name == "faults" and x is not None and y is not None:
            x, y = ((type(v).__name__, type(v.model).__name__,
                     dataclasses.asdict(v)) for v in (x, y))
        assert x == y or (x != x and y != y), (f.name, x, y)


@pytest.mark.parametrize("m", ["C", "J"])
def test_optimize_gives_equal_plans(m):
    """The optimizer half is the same float64 NumPy in the same order: the
    Plans are equal field for field."""
    r = RScenario(REdge.paper_sec_vii(), RConsts(**CONSTS), T_max=1e5,
                  C_max=0.25, step=RConstant(1e-3) if m == "C" else None)
    p = Scenario(EdgeSystem.paper_sec_vii(), MLProblemConstants(**CONSTS),
                 T_max=1e5, C_max=0.25,
                 step=ConstantRule(1e-3) if m == "C" else None)
    rp, pp = r.optimize(), p.optimize()
    assert pp.feasible and pp.objective.value == m
    _equal_plans(rp, pp)
    assert pp.round_bits() == rp.round_bits()
    assert pp.describe() == rp.describe()


def _jax_draws(key, n_local, K_max, B, D):
    """The JAX round's draws, re-derived from its key chain: split(key,
    N+1) gives the worker keys and the server key; each local step splits
    the worker key for its mini-batch; the worker's codec noise uses the
    same worker key that seeded its steps, the server's the server key."""
    keys = jax.random.split(key, N + 1)
    idx = np.zeros((N, K_max, B), np.int64)
    for n in range(N):
        k = keys[n]
        for step in range(K_max):
            k, bk = jax.random.split(k)
            idx[n, step] = np.asarray(jax.random.randint(bk, (B,), 0,
                                                         n_local))
    uw = np.stack([np.asarray(jax.random.uniform(keys[n], (D,), jnp.float32))
                   for n in range(N)])
    us = np.asarray(jax.random.uniform(keys[N], (D,), jnp.float32))
    return torch.from_numpy(idx), torch.tensor(uw), torch.tensor(us)


def test_round_matches_reference(tasks):
    """One round with the JAX package's draws injected.  Gradients differ
    by float32 rounding between XLA and PyTorch; where that (or the
    kernels' |y|*(s/norm) order) moves a value across a level boundary the
    result moves by one server level gamma*||delta||/s0 or 1/N of a worker
    level.  So: every coordinate within two server levels, and at most
    1e-3 of them off by more than 1e-6."""
    rtask, ptask = tasks
    rcfg = RPlan.manual(step_rule=RConstant(GAMMA), **QUICK) \
        .to_genqsgd_config()
    pcfg = Plan.manual(step_rule=ConstantRule(GAMMA), **QUICK) \
        .to_genqsgd_config()
    rdata = rtask.make_data(N)
    ralg = RGenQSGD(rtask.loss, rtask.sample, rcfg)
    palg = GenQSGD(ptask.loss, ptask.make_data(N), ptask.shapes, pcfg)
    p0 = rtask.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    x_r, m_r = ralg._round(p0, rdata, key, jnp.float32(GAMMA))
    x_r = np.asarray(r_flatten(x_r))
    x0 = flatten_like(params_from_jax({k: np.asarray(v)
                                       for k, v in p0.items()}, device="cpu"))
    draws = _jax_draws(key, palg.n_local, pcfg.K_max, pcfg.B, palg.dim)
    x_p, m_p = palg.round(x0, *draws, GAMMA)
    np.testing.assert_allclose(float(m_p["delta_norm"]),
                               float(m_r["delta_norm"]), rtol=1e-5)
    level = GAMMA * float(m_r["delta_norm"]) / S
    diff = np.abs(x_p.numpy() - x_r)
    assert diff.max() <= 2 * level + 1e-7, (diff.max(), level)
    assert (diff > 1e-6).mean() <= 1e-3
    # the round moved the model by about the reference's update
    np.testing.assert_allclose(float(m_p["update_norm"]),
                               float(m_r["update_norm"]), rtol=1e-3)


ROUNDS = 100


def test_short_run_matches_reference_spread(tasks):
    """A short run of the quickstart Plan: comm bits exactly
    rounds * (sum M_sn + M_s0), and test_acc / eval_loss within the spread
    of the JAX package over three seeds — twice the range of those three,
    plus 0.02, since a fourth seed of the same distribution may fall a
    little outside the three."""
    rtask, ptask = tasks
    sysp = EdgeSystem.paper_sec_vii()
    pscn = Scenario(sysp, MLProblemConstants(**CONSTS), T_max=1e5,
                    C_max=0.25)
    pplan = Plan.manual(step_rule=ConstantRule(GAMMA), **QUICK)
    # the JAX reference runtime as its Scenario.run drives it (init from
    # PRNGKey(seed), rounds from PRNGKey(seed + 1)), with one compiled
    # round shared by the three seeds
    ralg = RGenQSGD(rtask.loss, rtask.sample,
                    RPlan.manual(step_rule=RConstant(GAMMA), **QUICK)
                    .to_genqsgd_config(max_K0=ROUNDS))
    rdata = rtask.make_data(N)
    ref = [rtask.metrics(ralg.run(rtask.init_params(jax.random.PRNGKey(s)),
                                  rdata, jax.random.PRNGKey(s + 1))[0])
           for s in range(3)]
    rep = pscn.run(pplan, task=ptask, max_rounds=ROUNDS, device="cpu")
    assert rep.rounds == ROUNDS and rep.model_dim == 101770
    assert rep.comm_bits == ROUNDS * (float(np.sum(sysp.M_sn)) + sysp.M_s0)
    assert not rep.comm_bits_match          # a capped run is not the Plan
    for name in ("test_acc", "eval_loss"):
        vals = np.array([r[name] for r in ref])
        tol = 2 * np.ptp(vals) + 0.02
        assert abs(rep.final_metrics[name] - vals.mean()) <= tol, \
            (name, rep.final_metrics[name], vals)


@pytest.mark.parametrize("kw,item", [
    pytest.param({"sampling": "uniform"}, None, id="sampling-constructs"),
    pytest.param({"faults": "edge"}, None, id="faults-constructs"),
    pytest.param({"system": dataclasses.replace(EdgeSystem.paper_sec_vii(),
                                                q_dim=4096)}, None,
                 id="kw2-2"),
])
def test_scenario_outside_the_slice_raises(kw, item):
    """What the port does not carry raises naming its item; sampling and
    fault models (item 6) and a bucketed system (item 2) construct."""
    kw = {"system": EdgeSystem.paper_sec_vii(), **kw}
    if item is None:
        scn = Scenario(consts=MLProblemConstants(**CONSTS), T_max=1e5,
                       C_max=0.25, **kw)
        assert scn.sampling_obj.key == kw.get("sampling", "full")
        assert scn.faults_obj.key == kw.get("faults", "none")
        assert scn._priced_system.q_dim == kw["system"].q_dim
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        Scenario(consts=MLProblemConstants(**CONSTS), T_max=1e5, C_max=0.25,
                 **kw)


def _fused_optimize_is_the_numpy_plan(scn):
    """The fused solver (item 7), refused until this slice, runs on the CPU
    when asked and returns the scalar reference's Plan; the JAX package's
    backend names are refused, naming the port's."""
    scn = dataclasses.replace(scn, step=ConstantRule(1e-3))
    _equal_plans(scn.optimize(),
                 scn.optimize(backend="torch-fused", device="cpu"))
    for name in ("jnp", "jnp-fused"):
        with pytest.raises(ValueError, match="'torch-fused'"):
            scn.optimize(backend=name)


def _optimize_through_a_server(scn):
    """PlanServer (item 8), refused until its slice, serves
    ``optimize(server=...)``: the scalar reference's Plan, one request."""
    from repro_torch.serve import PlanServer
    scn = dataclasses.replace(scn, step=ConstantRule(1e-3))
    with PlanServer(backend="numpy", max_batch=2, window_s=0.0) as srv:
        plan = scn.optimize(server=srv)
    _equal_plans(scn.optimize(), plan)
    assert srv.stats()["submitted"] == 1


def _run_through_the_spmd_backend(scn):
    """The SPMD runtime (item 9), refused until its slice, runs a Plan of
    the N workers: an LM at a tiny width on the CPU, comm bits priced at
    the transport used; without an SpmdTask it says what it needs."""
    from repro_torch.api import SpmdTask
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data import uniform_lm_batch
    from repro_torch.models.registry import model_api
    plan = Plan.manual(K0=1, Kn=[1] * N, B=1, step_rule=ConstantRule(0.1),
                       s0=7, sn=7)
    with pytest.raises(ValueError, match="needs an SpmdTask"):
        scn.run(plan, backend="spmd")
    cfg = ArchConfig(name="tiny", family="dense", citation="test",
                     n_layers=1, d_model=16, n_heads=2, n_kv=1, d_ff=32,
                     vocab=32, d_head=8, pattern=("attn",))
    gen = torch.Generator().manual_seed(0)
    batches = iter(lambda: uniform_lm_batch(gen, (N, 1, 1, 8), cfg.vocab),
                   None)
    rep = scn.run(plan, task=SpmdTask(api=model_api(cfg), arch=cfg,
                                      batches=batches, device="cpu"),
                  backend="spmd", wire="int8", device="cpu")
    assert rep.backend == "spmd" and rep.rounds == 1
    assert rep.comm_bits == plan.round_bits(dim=rep.model_dim, wire="int8")


@pytest.mark.parametrize("call,item", [
    pytest.param(_fused_optimize_is_the_numpy_plan, None, id="<lambda>-7"),
    pytest.param(_optimize_through_a_server, None, id="<lambda>-8"),
    pytest.param(_run_through_the_spmd_backend, None, id="<lambda>-9"),
])
def test_entry_points_outside_the_slice_raise(call, item):
    scn = Scenario(EdgeSystem.paper_sec_vii(), MLProblemConstants(**CONSTS),
                   T_max=1e5, C_max=0.25)
    if item is None:
        call(scn)
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        call(scn)


@pytest.mark.parametrize("kw,error,match", [
    pytest.param({"bucket": 4096}, None, None, id="kw0-2"),
    pytest.param({"sampling_S": N + 1}, ValueError, "outside",
                 id="bad-sampling_S"),
    pytest.param({"faults": object()}, TypeError, "FaultSpec",
                 id="faults-not-a-FaultSpec"),
])
def test_runtime_outside_the_slice_raises(kw, error, match):
    """Per-bucket norms (item 2) construct and reach every codec of the
    runtime; a malformed cohort size or fault contract is refused as in
    the JAX package."""
    if error is None:
        cfg = GenQSGDConfig(K0=1, Kn=(1,) * N, B=1,
                            step_rule=ConstantRule(0.1), s0=S, sn=[S] * N,
                            **kw)
        alg = GenQSGD(lambda p, b: None, (torch.zeros(N, 1),) * 2,
                      {"w": (101770,)}, cfg)
        assert {c.bucket for c in alg.worker_codecs + [alg.server_codec]} \
            == {kw["bucket"]}
        return
    with pytest.raises(error, match=match):
        GenQSGDConfig(K0=1, Kn=(1,) * N, B=1, step_rule=ConstantRule(0.1),
                      **kw)


def _bucketed_codec_round_trips():
    """make_codec(7, bucket=4096): one norm a bucket, decode(encode(y))
    within one level of each bucket."""
    codec = make_codec(7, bucket=4096)
    y = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    lvl, norm = codec.encode(y, torch.rand(10000))
    assert norm.shape == (3,)
    err = (codec.decode(lvl, norm) - y).abs()
    assert bool((err <= norm.repeat_interleave(4096)[:10000] / 7).all())


def _elias_payload_round_trips():
    """The elias payload: encode_payload -> decode_payload is decode of
    encode's levels, and nbits is the realized stream."""
    codec = make_codec(7, wire="elias")
    y = torch.randn(800, generator=torch.Generator().manual_seed(1))
    u = torch.rand(800, generator=torch.Generator().manual_seed(2))
    words, norm, nbits = codec.encode_payload(y, u)
    assert 0 < int(nbits) <= 32 * words.numel()
    assert torch.equal(codec.decode_payload(words, norm, 800),
                       codec.decode(*codec.encode(y, u)))


@pytest.mark.parametrize("call", [
    pytest.param(_bucketed_codec_round_trips, id="<lambda>-2"),
    pytest.param(_elias_payload_round_trips, id="<lambda>-9"),
])
def test_codecs_outside_the_slice_raise(call):
    """Per-bucket norms (item 2) and the elias payload coder, refused
    until this slice, construct and round-trip."""
    call()


@pytest.mark.parametrize("s,pack,match", [(8, True, "s <= 7"),
                                          (128, False, "s <= 127")])
def test_fused_encode_refuses_s_outside_its_container(s, pack, match):
    """The one-pass encodes carry int8 levels and int4 nibbles, as the JAX
    package's: no wider container."""
    y = torch.zeros(1, 8)
    with pytest.raises(ValueError, match=match):
        encode_fused(y, s, y, pack=pack)
    with pytest.raises(ValueError, match=match):
        encode_rotated_fused(y, s, y, 0, pack=pack)


def test_no_quiet_cpu_fallback(monkeypatch):
    """Entry points default to the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MNISTTask()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")
    scn = Scenario(EdgeSystem.paper_sec_vii(), MLProblemConstants(**CONSTS),
                   T_max=1e5, C_max=0.25)
    with pytest.raises(RuntimeError, match="CUDA"):
        scn.run(Plan.manual(K0=1, Kn=[1] * N, B=1,
                            step_rule=ConstantRule(0.1)))


def test_same_device(monkeypatch):
    """The run's device check: a bare "cuda" is the current card, so a task
    on cuda:0 runs under device="cuda" and the converse; another index or
    another type is another device.  No card is needed: the current
    device is stubbed, and asked only when one side has no index."""
    asked = []

    def current():
        asked.append(1)
        return 0

    monkeypatch.setattr(torch.cuda, "current_device", current)
    same = repro_torch.same_device
    assert same("cpu", "cpu") and same(torch.device("cpu"), "cpu")
    assert same("cuda:1", torch.device("cuda", 1)) and not asked
    assert not same("cuda:0", "cuda:1") and not same("cpu", "cuda:0")
    assert not asked
    assert same("cuda", "cuda:0") and same("cuda:0", "cuda")
    assert not same("cuda", "cuda:1") and same("cuda", "cuda")
    assert len(asked) == 3
