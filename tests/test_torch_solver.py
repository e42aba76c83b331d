"""The batched and fused GIA solver of the port (``repro_torch.opt``: the
``"torch"`` GP backend, the ``"torch-fused"`` GIA) on the CPU, held
against the JAX package at N = 4, dim = 1024: packed and refresh-plan
arrays equal, the torch refresh within the ulp budgets of
``tests/unit/test_refresh_parity.py``, and Plans by the targets of
``tests/unit/test_opt_engine.py`` against the JAX package's NumPy batched
solver (its jnp engines do not import where ``jax.experimental`` has no
``enable_x64``) over every family x {C, E, D, J}."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as R
from repro.opt import GPStructure as RStructure
from repro.opt import solve_param_opt_batched as r_batched
from repro.opt.refresh import RefreshPlan as RPlan
from repro.opt.refresh import make_refresh as r_make_refresh
import repro_torch.api as P
from repro_torch.opt import (GPStructure, RefreshPlan, solve_gp_batch,
                             solve_param_opt_batched)
from repro_torch.opt import gia_fused
from repro_torch.opt.gp import solve_gp
from repro_torch.opt.refresh import arrays_to, make_project, make_refresh
from repro_torch.opt.structure import PAD_LOGC

CONSTS = dict(L=0.084, sigma=33.18, G=33.63, f_gap=2.3, N=4)
STEPS = {"C": ("ConstantRule", (0.01,)),
         "E": ("ExponentialRule", (0.02, 0.9995)),
         "D": ("DiminishingRule", (0.02, 600.0)), "J": None}
FAMILIES = ("genqsgd", "pm", "fa", "pr", "gqfedwavg")
GRID = [(f, m) for f in FAMILIES for m in "CEDJ"]
#: ulp budget of the refresh in log space (tests/unit/test_refresh_parity.py)
ULP_BUDGET = {"C": 1.0, "D": 1.0, "J": 1.0, "E": 4.0}


@pytest.fixture(autouse=True)
def one_thread():
    """The solver's tensors are a few rows wide: intra-op threads only add
    overhead on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario(mod, family, m, C_max=0.25, T_max=1e5, sampling="full"):
    step = STEPS[m]
    step = None if step is None else getattr(mod, step[0])(*step[1])
    return mod.Scenario(system=mod.EdgeSystem.paper_sec_vii(dim=1024, N=4),
                        consts=mod.MLProblemConstants(**CONSTS), T_max=T_max,
                        C_max=C_max, family=family, step=step,
                        sampling=sampling)


def problems(mod, family, m, budgets=(0.25, 0.3), **kw):
    return [scenario(mod, family, m, C_max=c, **kw).problem()
            for c in budgets]


def assert_plan_targets(ref, got):
    """The JAX package's fused-vs-numpy targets, row by row.  A row that
    never had a feasible GIA iteration ends on a stalled phase-I
    (min-slack) point: its z is held at the JAX full grid's 1e-4
    (measured: fa/E, 2.5e-5 from NumPy on both torch engines)."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.feasible == b.feasible
        assert a.iterations == b.iterations
        assert len(a.history) == len(b.history)
        atol = 1e-5 if a.iterations else 1e-4
        assert np.allclose(a.z, b.z, atol=atol, rtol=0)
        assert (a.K0, a.B) == (b.K0, b.B)
        assert np.array_equal(a.Kn, b.Kn)
        assert b.E == pytest.approx(a.E, rel=1e-9)
        assert b.history == pytest.approx(a.history, rel=1e-9)


def assert_bitwise(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert np.array_equal(a.z, b.z)
        assert a.history == b.history
        assert (a.iterations, a.converged) == (b.iterations, b.converged)
        assert (a.K0, a.B, a.E) == (b.K0, b.B, b.E)


def ulps(got, ref):
    return np.abs(got - ref) / np.spacing(np.maximum(np.abs(got),
                                                     np.abs(ref)))


# ---------------------------------------------------------------------------
# layouts: packed batches and refresh plans equal to the JAX package's
# ---------------------------------------------------------------------------
SIGNATURES = [pytest.param(f, m, "full", id=f"{f}-{m}") for f, m in GRID] \
    + [pytest.param("genqsgd", m, "uniform", id=f"genqsgd-{m}-free-S")
       for m in "CDJ"]


@pytest.mark.parametrize("family,m,sampling", SIGNATURES)
def test_packed_and_plan_arrays_equal(family, m, sampling):
    rp = problems(R, family, m, sampling=sampling)
    pp = problems(P, family, m, sampling=sampling)
    rpack = RStructure(rp[0]).pack_batch(rp, [p.z_init() for p in rp])
    ppack = GPStructure(pp[0]).pack_batch(pp, [p.z_init() for p in pp])
    for f in ("n", "m_cons", "seg", "obj_logc", "obj_A", "con_logc", "con_A",
              "z0", "active"):
        assert np.array_equal(getattr(rpack, f), getattr(ppack, f)), f
    rplan, pplan = RPlan.build(rp), RefreshPlan.build(pp)
    assert pplan.signature_key == rplan.signature_key
    assert pplan.sampled == (sampling != "full")
    for f in ("seg", "obj_logc", "obj_A", "skel_logc", "skel_A"):
        assert np.array_equal(getattr(pplan, f), getattr(rplan, f)), f
    assert sorted(pplan.arrays) == sorted(rplan.arrays)
    for k, v in rplan.arrays.items():
        assert np.array_equal(pplan.arrays[k], v), k


# ---------------------------------------------------------------------------
# the torch refresh against condense.py and the JAX package's jnp mirror
# ---------------------------------------------------------------------------
def torch_refresh(plan, zs):
    a = arrays_to(plan.arrays, "cpu")
    z = make_project(plan.m, plan.i_x0)(torch.as_tensor(np.stack(zs)), a)
    logc, A = make_refresh(plan.m, plan.n, plan.caps, plan.sampled)(z, a)
    return z.numpy(), logc.numpy(), A.numpy()


@pytest.mark.parametrize("family,m,sampling", SIGNATURES)
def test_refresh_matches_condense_and_jax(family, m, sampling):
    """Per-constraint (log c, A) of the torch refresh equal conv_block's
    surrogates to the ulp budget (C/D/J 1 ulp, E 4 ulp; measured: 0 ulp at
    C/D/J, <= 4 at E), padding slots carry exactly PAD_LOGC, exponent rows
    agree to 4e-15.  Against the JAX package's ``make_refresh`` (vmapped,
    x64) each slot may differ by the budget plus that slot's own distance
    from conv_block: with this container's jax the jnp mirror misses its
    budget at fa/E (slot 1, 16 ulp) and the free-S C (slot 9, 44 ulp) and
    D (slot 5, 6 ulp) refreshes, and under ``jax.jit`` fa/D's slot 3
    (log c ~ 1.2e-3) moves by 1,023 ulp, so the JAX side is not jitted."""
    pp = problems(P, family, m, budgets=(0.22, 0.25, 0.3), sampling=sampling)
    rp = problems(R, family, m, budgets=(0.22, 0.25, 0.3), sampling=sampling)
    plan = RefreshPlan.build(pp)
    zs = [p.project_expansion(p.z_init()) for p in pp]
    zt, logc, A = torch_refresh(plan, zs)
    assert np.array_equal(zt, np.stack(zs))       # the projection, bitwise
    ref = np.full_like(logc, PAD_LOGC)
    live = np.zeros(logc.shape, dtype=bool)
    for i, p in enumerate(pp):
        conv = p.conv_block(zs[i])
        assert len(conv) == len(plan.caps)
        off = 0
        for cap, c in zip(plan.caps, conv):
            k = c.n_terms
            assert k <= cap
            ref[i, off:off + k] = np.log(c.c)
            live[i, off:off + k] = True
            assert np.abs(A[i, off:off + k] - c.A).max(initial=0.0) <= 4e-15
            off += cap
    budget = ULP_BUDGET[m]
    u = ulps(logc[live], ref[live])
    assert np.all(u <= budget), (family, m, u.max())
    assert np.all(logc[~live] == PAD_LOGC)
    rplan = RPlan.build(rp)
    with jax.enable_x64(True):
        jl, jA = jax.vmap(r_make_refresh(rplan.m, rplan.n, rplan.caps,
                                         rplan.sampled))(np.stack(zs),
                                                         rplan.arrays)
        jl, jA = np.asarray(jl), np.asarray(jA)
    slack = ulps(jl[live], ref[live])
    assert np.all(ulps(logc[live], jl[live]) <= budget + slack)
    assert np.all(jl[~live] == PAD_LOGC)
    assert np.abs(A - jA).max() <= 4e-15


def test_refresh_tracks_scalar_gia_trajectory():
    """Parity holds at later expansion points too — replay two scalar GIA
    steps and compare the refresh at each visited point, bitwise."""
    p = problems(P, "genqsgd", "C", budgets=(0.25,))[0]
    z = p.project_expansion(p.z_init())
    for _ in range(2):
        plan = RefreshPlan.build([p])
        _, logc, _ = torch_refresh(plan, [z])
        conv = p.conv_block(z)
        offs = np.cumsum((0,) + plan.caps[:-1])
        got = np.concatenate([logc[0, o:o + c.n_terms]
                              for o, c in zip(offs, conv)])
        assert np.array_equal(got, np.concatenate([np.log(c.c)
                                                   for c in conv]))
        z = p.project_expansion(solve_gp(p.build(z), z).z)


# ---------------------------------------------------------------------------
# the "torch" GP backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", ["C", "J"])
def test_gp_batch_torch_matches_jax_numpy(m):
    rp, pp = problems(R, "genqsgd", m), problems(P, "genqsgd", m)
    from repro.opt import solve_gp_batch as r_solve_gp_batch
    rn = r_solve_gp_batch(RStructure(rp[0]).pack_batch(
        rp, [p.z_init() for p in rp]), backend="numpy")
    rt = solve_gp_batch(GPStructure(pp[0]).pack_batch(
        pp, [p.z_init() for p in pp]), backend="torch", device="cpu")
    assert np.array_equal(rn.feasible, rt.feasible)
    assert np.allclose(rn.z, rt.z, atol=1e-6, rtol=0)
    assert np.allclose(rn.obj, rt.obj, rtol=1e-8)


@pytest.mark.parametrize("family,m", [("genqsgd", "C")])
def test_batched_torch_gia_matches_jax_numpy(family, m):
    assert_plan_targets(r_batched(problems(R, family, m), backend="numpy"),
                        solve_param_opt_batched(problems(P, family, m),
                                                backend="torch",
                                                device="cpu"))


def test_backends_refused():
    pp = problems(P, "genqsgd", "C")
    pack = GPStructure(pp[0]).pack_batch(pp, [p.z_init() for p in pp])
    with pytest.raises(ValueError, match="unknown GP backend"):
        solve_gp_batch(pack, backend="cvxpy")
    for name in ("jnp", "jnp-fused"):
        with pytest.raises(ValueError, match="'torch-fused'"):
            solve_gp_batch(pack, backend=name)
        with pytest.raises(ValueError, match="'torch'"):
            solve_param_opt_batched(pp, backend=name, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        solve_param_opt_batched(pp, backend="torch-fused")


# ---------------------------------------------------------------------------
# the fused engine against the JAX package's NumPy batched solver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,m", GRID, ids=[f"{f}-{m}" for f, m in GRID])
def test_fused_matches_jax_numpy(family, m):
    """Every family x {C, E, D, J}: same feasibility, GIA iterations and
    history length, integer recovery equal, E and history within rel 1e-9,
    the continuous point within 1e-5 (the m=J restart included).  One
    budget a cell: the batches of several rows are the tests below."""
    budgets = (0.25,)
    assert_plan_targets(
        r_batched(problems(R, family, m, budgets), backend="numpy"),
        solve_param_opt_batched(problems(P, family, m, budgets),
                                backend="torch-fused", device="cpu"))


def fused(probs, **kw):
    return solve_param_opt_batched(probs, backend="torch-fused",
                                   device="cpu", **kw)


def test_fused_one_build_per_signature():
    """Re-solving a same-signature batch reuses the step program: the build
    counter (a capture on the card) does not move."""
    probs = problems(P, "genqsgd", "C", budgets=(0.22, 0.25, 0.3))
    key = RefreshPlan.build(probs).signature_key
    fused(probs)
    n1 = gia_fused.capture_count(key)
    assert n1 >= 1
    hits = gia_fused.compile_cache_info().hits
    fused(problems(P, "genqsgd", "C", budgets=(0.21, 0.26, 0.31)))
    assert gia_fused.capture_count(key) == n1
    assert gia_fused.compile_cache_info().hits == hits + 1


def stalled_rows(mod):
    """A healthy row, a hopeless one (budgets no point can meet: its GIA
    stalls out through phase-I retries) and a second healthy row."""
    return [scenario(mod, "genqsgd", "C", C_max=0.25).problem(),
            scenario(mod, "genqsgd", "C", C_max=1e-9, T_max=10.0).problem(),
            scenario(mod, "genqsgd", "C", C_max=0.3).problem()]


@pytest.fixture(scope="module")
def stalled_batch():
    """The two healthy rows solved alone, then all three rows in one batch
    padded to 8, the first warm-started at its solo solution (the
    hopeless row's stall-out dominates the cost: solved once, read by the
    two tests below)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = stalled_rows(P)
        solo_h, solo_o = fused(rows[:1])[0], fused(rows[2:])[0]
        z0s = [solo_h.z, None, None]
        return solo_h, solo_o, z0s, fused(rows, z0s=z0s, pad_to=8)
    finally:
        torch.set_num_threads(n)


def test_fused_stalled_instance_regression(stalled_batch):
    """A hopeless row inside a fused batch neither breaks the device
    refresh nor stretches a healthy row's lockstep: the cold healthy row
    is bitwise its solo solve."""
    _, solo_o, _, (_, bad, cold) = stalled_batch
    assert not bad.feasible and not bad.converged
    assert cold.feasible == solo_o.feasible
    assert_bitwise([solo_o], [cold])
    assert np.array_equal(cold.Kn, solo_o.Kn)


def test_fused_mixed_warm_cold_with_stalled_row(stalled_batch):
    """A stalled row inside a mixed warm/cold batch padded to 8 rows does
    not perturb the warm row: it re-converges in 1-3 iterations onto its
    cold KKT point (integer recovery equal) and meets the Plan targets
    against the JAX package's NumPy warm solve from the same start.  (The
    JAX test's 1e-6 between the warm and the cold point is not met by the
    NumPy reference itself here: at tol 1e-4 its warm row sits 1.01e-6
    from its cold one.)"""
    solo_h, _, z0s, (warm, _, _) = stalled_batch
    assert warm.converged and 1 <= warm.iterations <= 3
    assert (warm.K0, warm.B) == (solo_h.K0, solo_h.B)
    assert np.array_equal(warm.Kn, solo_h.Kn)
    assert np.allclose(warm.z, solo_h.z, atol=1e-5, rtol=0)
    assert_plan_targets(
        r_batched(stalled_rows(R)[:1], z0s=z0s[:1], backend="numpy"), [warm])


def test_fused_pad_to_rows_bitwise_unchanged():
    """Padding a fused batch to a fixed shape (the serving path) is a
    bitwise no-op for the real rows."""
    probs = problems(P, "genqsgd", "C", budgets=(0.22, 0.25, 0.3))
    assert_bitwise(fused(probs), fused(probs, pad_to=8))


def test_fused_chunk_size_bitwise(monkeypatch):
    """Steps past every row's end change no bit: one step a chunk and 64
    steps a chunk give the same rows."""
    probs = problems(P, "genqsgd", "C")
    out = {}
    for chunk in (1, 64):
        monkeypatch.setattr(gia_fused, "_CHUNK", chunk)
        out[chunk] = fused(probs)
    assert_bitwise(out[1], out[64])


def test_optimize_fused_is_the_numpy_plan():
    """``Scenario.optimize(backend="torch-fused", device="cpu")`` returns
    the scalar reference's Plan; a second Scenario of the signature reuses
    the process-level program."""
    from repro_torch.opt.refresh import RefreshPlan as Plan_
    s1 = scenario(P, "genqsgd", "C", C_max=0.24)
    s2 = scenario(P, "genqsgd", "C", C_max=0.28)
    key = Plan_.build([s1.problem()]).signature_key
    p1 = s1.optimize(backend="torch-fused", device="cpu")
    n1 = gia_fused.capture_count(key)
    p2 = s2.optimize(backend="torch-fused", device="cpu")
    assert gia_fused.capture_count(key) == n1 >= 1
    assert p1.feasible and p2.feasible
    assert dataclasses.asdict(p2) == dataclasses.asdict(s2.optimize())
    with pytest.raises(RuntimeError, match="CUDA card"):
        s1.optimize(backend="torch-fused")
