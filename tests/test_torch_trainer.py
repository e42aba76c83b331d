"""The federated LM trainer of repro_torch (``repro_torch.train``) and
``Scenario.run(backend="spmd")`` against the JAX package on the CPU.

- ``round_comm_bits``: equal over wires, buckets and cohorts.
- Cohort traces and ``FaultTrace``s of a sampled and faulted run: equal to
  the JAX package's host draws for the seed (its ``draw_cohort`` on
  ``default_rng(seed)``, its ``FaultDriver`` on ``fault_rng(seed)``, the
  trainer's calls in order), equal across two runs of one seed, different
  for another seed, the report carrying ``backend="spmd"``.
- Checkpoints: a file the port writes loads in the JAX package's ``load``
  and the other way round (zstd files where ``zstandard`` is installed).
- ``tests/integration/test_spmd_report.py``'s checks on the port's
  ``Scenario.run(backend="spmd")`` at qwen3-smoke, for genqsgd and
  gqfedwavg: comm bits ``rounds * plan.round_bits(dim, wire)``, cost-model
  E and T at the executed rounds, a finite loss in the history.
- ``Plan.to_fed_config``: the same refusals and the same config.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro.faults as RF
import repro.fed.runtime as RR
import repro.sampling.base as RS
import repro.train.checkpoint as RC
import repro.train.trainer as RT
import repro_torch.api as P
import repro_torch.faults as PF
import repro_torch.train.checkpoint as PC
from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost import energy_cost, time_cost
from repro_torch.data import uniform_lm_batch
from repro_torch.fed import FedConfig, tree_leaves
from repro_torch.models.registry import get_config, model_api
from repro_torch.train import GenQSGDTrainer, round_comm_bits
from tests.torch_fed_cases import TINY

FL, B, S = 2, 4, 32
KN = (1, 2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg):
    gen = torch.Generator().manual_seed(0)
    while True:
        yield uniform_lm_batch(gen, (FL, max(KN), B, S), cfg.vocab)


def _consts(mod):
    return mod.MLProblemConstants(L=0.084, sigma=33.18, G=33.63, f_gap=2.3,
                                  N=FL)


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(s0=64, sn=16, wire="f32"), dict(s0=64, sn=(16, 127), wire="int8"),
    dict(s0=7, sn=(7, 5), wire="int4"), dict(s0=64, sn=16, wire="rs_ag"),
    dict(s0=7, sn=(5, 7), wire="elias"), dict(s0=None, sn=None, wire="f32"),
    dict(s0=None, sn=7, wire="int4"),
    dict(s0=64, sn=16, wire="int8", bucket=4096),
    dict(s0=7, sn=7, wire="elias", bucket=256)])
@pytest.mark.parametrize("cohort", [None, [1], [0, 1]])
def test_round_comm_bits_equal(kw, cohort):
    for dim in (4096, 1312256, 1720574976):
        assert round_comm_bits(FedConfig(n_workers=FL, Kn=KN, **kw), dim,
                               cohort) == \
            RT.round_comm_bits(RR.FedConfig(n_workers=FL, Kn=KN, **kw), dim,
                               cohort)


# ---------------------------------------------------------------------------
# cohorts and faults
# ---------------------------------------------------------------------------
def _spec(mod):
    fm = mod.edge_faults(straggler_prob=0.5, straggler_factor=4.0,
                         crash_prob=0.3, crash_rounds=1, corrupt_prob=0.1,
                         deadline_slack=1.5)
    wt = (0.8, 1.0)
    return mod.FaultSpec(model=fm, worker_times=wt, deadline=1.5,
                         deliver_p=tuple(fm.deliver_prob(np.asarray(wt),
                                                         1.5)))


def _host_replay(seed, rounds, sampled: bool):
    """The JAX package's trainer draws, in its order: a cohort from
    default_rng(seed) (when sampling), then the fault driver's step."""
    rng = np.random.default_rng(seed) if sampled else None
    drv = RF.FaultDriver(_spec(RF), FL, None)
    frng = RF.fault_rng(seed)
    cohorts = []
    for r in range(rounds):
        idx = pi = None
        if rng is not None:
            idx, pi = RS.draw_cohort(rng, FL, 1, None)
            cohorts.append(idx)
        drv.step(frng, r, idx, pi)
    return cohorts, drv.trace()


def _faulty_plan(sampled: bool):
    plan = P.Plan.manual(K0=4, Kn=KN, B=B, step_rule=P.ConstantRule(0.01),
                         s0=64, sn=16, dim=4096, faults=_spec(PF))
    return dataclasses.replace(plan, cohort_S=1) if sampled else plan


def _spmd_run(plan, seed):
    cfg = ArchConfig(**TINY)
    scn = P.Scenario(system=P.EdgeSystem.paper_sec_vii(dim=4096, N=FL),
                     consts=_consts(P), T_max=1e5, C_max=0.25)
    task = P.SpmdTask(api=model_api(cfg), arch=cfg, batches=_batches(cfg),
                      device="cpu")
    return scn.run(plan, task=task, backend="spmd", wire="f32", seed=seed,
                   log_every=1, device="cpu")


@pytest.mark.parametrize("sampled", [False, True])
def test_cohorts_and_fault_traces_equal(sampled):
    plan = _faulty_plan(sampled)
    r1 = _spmd_run(plan, 11)
    r2 = _spmd_run(plan, 11)
    cohorts, trace = _host_replay(11, plan.K0, sampled)
    assert r1.backend == "spmd" and len(r1.fault_trace) == plan.K0
    assert dataclasses.asdict(r1.fault_trace) == dataclasses.asdict(trace)
    assert r1.fault_trace == r2.fault_trace
    assert r1.fault_trace.workers_dropped > 0
    assert len(r1.round_bits_trace) == (plan.K0 if sampled else 0)
    if sampled:
        assert [list(c) for c in cohorts] == \
            [[int(i) for i in c] for c in _cohorts_of(plan, 11)]
    r3 = _spmd_run(plan, 12)
    assert r3.fault_trace != r1.fault_trace


def _cohorts_of(plan, seed):
    """The port trainer's cohort trace for a seed."""
    cfg = ArchConfig(**TINY)
    fed = plan.to_fed_config(seed=seed)
    tr = GenQSGDTrainer(model_api(cfg), cfg, fed, step_rule=plan.step_rule,
                        device="cpu")
    tr.run(tr.init(seed), _batches(cfg), seed + 1, n_rounds=plan.K0,
           log_every=plan.K0)
    return tr.cohort_trace


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _tree(lib, dt):
    return {"w": lib.ones((3, 4), dtype=dt) * 1.5,
            "segments": [{"b": lib.arange(5, dtype=lib.int32),
                          "a": lib.zeros((2,), dtype=dt)}]}


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _tree(torch, torch.float32)
    tree["h"] = torch.linspace(-1, 1, 7).to(torch.bfloat16)
    PC.save(str(tmp_path / "p.ckpt"), tree, {"round": 7, "note": "x"})
    assert (tmp_path / "p.ckpt").read_bytes()[:4] == b"RZL1"
    arrays, meta = RC.load(str(tmp_path / "p.ckpt"))
    assert meta == {"round": 7, "note": "x"}
    for k, t in PC.tree_paths(tree).items():
        a = arrays[k]
        assert a.shape == tuple(t.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      t.to(torch.float64).numpy())
    assert str(arrays["h"].dtype) == "bfloat16"


@pytest.mark.parametrize("zstd", [True, False])
def test_reference_checkpoint_loads_in_the_port(tmp_path, monkeypatch, zstd):
    if not zstd:
        monkeypatch.setattr(RC, "zstandard", None)
    tree = _tree(jnp, jnp.float32)
    tree["h"] = jnp.linspace(-1, 1, 7).astype(jnp.bfloat16)
    RC.save(str(tmp_path / "r.ckpt"), tree, {"round": 3})
    magic = (tmp_path / "r.ckpt").read_bytes()[:4]
    assert magic == (b"RZL1" if not zstd or RC.zstandard is None
                     else b"RZS1")
    like = jax.tree.map(lambda a: torch.zeros(a.shape), tree)
    back, meta = PC.load(str(tmp_path / "r.ckpt"), like=like, device="cpu")
    assert meta == {"round": 3}
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      b.to(torch.float64).numpy())
    if magic == b"RZS1":
        monkeypatch.setattr(PC, "zstandard", None)
        with pytest.raises(RuntimeError, match="zstandard"):
            PC.load(str(tmp_path / "r.ckpt"), device="cpu")


def test_trainer_writes_checkpoints_the_reference_reads(tmp_path):
    cfg = ArchConfig(**TINY)
    fed = FedConfig(n_workers=FL, Kn=KN, s0=7, sn=7, wire="int8")
    tr = GenQSGDTrainer(model_api(cfg), cfg, fed,
                        step_rule=P.ConstantRule(0.05),
                        checkpoint_dir=str(tmp_path), device="cpu")
    state = tr.run(tr.init(0), _batches(cfg), 1, n_rounds=2, log_every=1,
                   ckpt_every=2)
    arrays, meta = RC.load(str(tmp_path / "round_000002.ckpt"))
    assert meta == {"round": 2} and state.round == 2
    for k, t in PC.tree_paths(state.params).items():
        np.testing.assert_array_equal(arrays[k], t.numpy())
    assert [h["round"] for h in state.history] == [0, 1]


# ---------------------------------------------------------------------------
# Scenario.run(backend="spmd")
# ---------------------------------------------------------------------------
_PLANS = {
    "genqsgd": dict(),
    # weighted aggregation + normalized momentum ride through FedConfig;
    # the transport moves plain QSGD levels
    "gqfedwavg": dict(family="gqfedwavg", agg_weights=(0.7, 0.3),
                      momentum=0.5, normalize=True),
}


@pytest.mark.parametrize("fam", sorted(_PLANS))
def test_spmd_run_report(fam):
    cfg = get_config("qwen3-1.7b", smoke=True)
    plan = P.Plan.manual(K0=3, Kn=KN, B=B, step_rule=P.ConstantRule(0.01),
                         s0=64, sn=16, dim=4096, **_PLANS[fam])
    scn = P.Scenario(system=P.EdgeSystem.paper_sec_vii(dim=4096, N=FL),
                     consts=_consts(P), T_max=1e5, C_max=0.25, family=fam)
    task = P.SpmdTask(api=model_api(cfg), arch=cfg, batches=_batches(cfg),
                      device="cpu")
    rep = scn.run(plan, task=task, backend="spmd", wire="int8", log_every=1,
                  device="cpu")
    assert rep.backend == "spmd" and rep.rounds == plan.K0
    assert rep.model_dim == 1312256
    assert rep.comm_bits == rep.rounds * plan.round_bits(
        dim=rep.model_dim, wire="int8")
    psys = scn._priced_system
    assert rep.measured_E == energy_cost(psys, rep.rounds,
                                         np.asarray(plan.Kn), plan.B)
    assert rep.measured_T == time_cost(psys, rep.rounds,
                                       np.asarray(plan.Kn), plan.B)
    assert rep.wall_time_s > 0 and math.isfinite(rep.wall_time_s)
    assert rep.history and math.isfinite(rep.history[-1]["loss"])
    assert rep.final_metrics


def test_spmd_run_refusals():
    scn = P.Scenario(system=P.EdgeSystem.paper_sec_vii(dim=4096, N=FL),
                     consts=_consts(P), T_max=1e5, C_max=0.25)
    plan = P.Plan.manual(K0=1, Kn=KN, B=B, step_rule=P.ConstantRule(0.01),
                         s0=64, sn=16)
    with pytest.raises(ValueError, match="needs an SpmdTask"):
        scn.run(plan, backend="spmd", device="cpu")
    cfg = ArchConfig(**TINY)
    task = P.SpmdTask(api=model_api(cfg), arch=cfg, batches=_batches(cfg),
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="task lives on cpu"):
            scn.run(plan, task=task, backend="spmd")
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        scn.run(plan, backend="tpu")


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    cfg = ArchConfig(**TINY)
    fed = FedConfig(n_workers=FL, Kn=KN, s0=7, sn=7)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenQSGDTrainer(model_api(cfg), cfg, fed,
                       step_rule=P.ConstantRule(0.05))


# ---------------------------------------------------------------------------
# to_fed_config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire,s0,sn", [("bogus", 7, 7), ("int4", 8, 7),
                                        ("int4", 7, 9), ("int8", 128, 7),
                                        ("elias", 7, 200), ("f32", 16384, 7)])
def test_to_fed_config_refusals_equal(wire, s0, sn):
    msgs = []
    for mod in (R, P):
        plan = mod.Plan.manual(K0=1, Kn=KN, B=B,
                               step_rule=mod.ConstantRule(0.1), s0=s0, sn=sn)
        with pytest.raises(ValueError) as e:
            plan.to_fed_config(wire=wire)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("wire", ["f32", "int8", "int4", "rs_ag", "elias"])
def test_to_fed_config_equal(wire):
    kw = dict(K0=2, Kn=KN, B=B, s0=7, sn=(7, 5), q_dim=None,
              family="gqfedwavg", agg_weights=(3.0, 1.0), momentum=0.5,
              normalize=True)
    got = P.Plan.manual(step_rule=P.ConstantRule(0.1), **kw) \
        .to_fed_config(wire=wire, microbatch=2, seed=4)
    want = R.Plan.manual(step_rule=R.ConstantRule(0.1), **kw) \
        .to_fed_config(wire=wire, microbatch=2, seed=4)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
