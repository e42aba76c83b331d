"""``Scenario.sweep`` / ``sweep_scenarios`` / ``SweepReport`` of the port on
the CPU, held against the JAX package's NumPy sweeps at N = 4,
dim = 1024 (ports of ``tests/unit/test_opt_engine.py``'s sweep tests)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro_torch.api import SweepReport, sweep_scenarios

CONSTS = dict(L=0.084, sigma=33.18, G=33.63, f_gap=2.3, N=4)
#: the row fields that come from the integer point and the solve's count
EXACT = ("name", "family", "m", "gamma", "T_max", "C_max", "K0", "Kn", "B",
         "N", "S", "sampling", "T", "C", "feasible", "iterations")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario(mod, m="C", C_max=0.25, family="genqsgd"):
    step = {"C": mod.ConstantRule(0.01), "J": None,
            "D": mod.DiminishingRule(0.02, 600.0)}[m]
    return mod.Scenario(system=mod.EdgeSystem.paper_sec_vii(dim=1024, N=4),
                        consts=mod.MLProblemConstants(**CONSTS), T_max=1e5,
                        C_max=C_max, family=family, step=step)


def assert_rows_match(ref, got):
    """Rows equal field for field, E within rel 1e-9 (converged may differ
    only where the reference's did not converge either way: it never
    does here)."""
    assert len(ref) == len(got)
    for a, b in zip(ref.rows, got.rows):
        assert {k: a[k] for k in EXACT} == {k: b[k] for k in EXACT}
        assert b["E"] == pytest.approx(a["E"], rel=1e-9)
        assert a["converged"] == b["converged"]


@pytest.mark.parametrize("backend", ["torch", "torch-fused"])
def test_scenario_sweep_matches_jax_numpy(backend):
    """``Scenario.sweep`` over a budget grid on the CPU: one group, rows
    equal to the JAX package's NumPy sweep, Plans equal to pointwise
    ``optimize`` (Fig.-5a monotonicity: a tighter budget costs more)."""
    grid = [0.22, 0.3]
    rep = scenario(P).sweep(over={"cmax": grid}, backend=backend,
                            device="cpu")
    ref = scenario(R).sweep(over={"cmax": grid}, backend="numpy")
    assert len(rep) == 2 and rep.backend == backend and rep.n_groups == 1
    assert_rows_match(ref, rep)
    for c, row, plan in zip(grid, rep.rows, rep.plans):
        one = dataclasses.replace(scenario(P), C_max=c).optimize()
        assert row["C_max"] == c and row["feasible"] and plan.feasible
        assert (plan.K0, plan.Kn, plan.B) == (one.K0, one.Kn, one.B)
        assert plan.predicted_E == pytest.approx(one.predicted_E, rel=1e-9)
    assert rep.rows[0]["E"] > rep.rows[1]["E"]


@pytest.mark.parametrize("backend,parallel", [("numpy", False),
                                              ("torch-fused", True)])
def test_sweep_heterogeneous_groups_and_names(backend, parallel):
    """Mixed signatures group per (m, family, N); names and order survive;
    the NumPy sweep's rows equal the JAX package's, and the fused groups
    solved on a thread pool match them (the card runs both settings of
    ``parallel`` through the fused engine: chip_smoke.py)."""
    m = "J" if backend == "numpy" else "D"     # D: no restart to pay

    def scns(mod):
        return [scenario(mod), scenario(mod, m),
                scenario(mod, C_max=0.3), scenario(mod, family="pm")]

    names = ["a", "b", "c", "d"]
    rep = sweep_scenarios(scns(P), names=names, backend=backend,
                          parallel=parallel, device="cpu")
    ref = R.sweep_scenarios(scns(R), names=names, backend="numpy",
                            parallel=False)
    assert [r["name"] for r in rep] == names
    assert rep.n_groups == 3        # C-budget pair batches, the others solo
    assert [r["m"] for r in rep] == ["C", m, "C", "C"]
    if backend == "numpy":
        assert rep.rows == ref.rows
    assert_rows_match(ref, rep)


def test_sweep_backends_and_device():
    """``"auto"`` is the fused engine on the card: with no card it raises
    unless ``device="cpu"``; the JAX package's names raise ValueError."""
    scn = scenario(P)
    with pytest.raises(RuntimeError, match="CUDA card"):
        scn.sweep(over={"cmax": [0.25]})
    rep = scn.sweep(over={"cmax": [0.25]}, device="cpu")
    assert rep.backend == "torch-fused"
    for name in ("jnp", "jnp-fused"):
        with pytest.raises(ValueError, match="'torch-fused'"):
            scn.sweep(over={"cmax": [0.25]}, backend=name, device="cpu")


def test_sweep_over_validation():
    scn = scenario(P)
    with pytest.raises(ValueError, match="cannot sweep over"):
        scn.sweep(over={"warp_factor": [9]}, device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        scn.sweep(over={"cmax": [0.2], "C_max": [0.3]}, device="cpu")


def _report_from(points):
    rows = tuple({"name": f"p{i}", "E": e, "T": t, "C": c, "feasible": f}
                 for i, (e, t, c, f) in enumerate(points))
    return SweepReport(rows=rows, plans=(None,) * len(rows),
                       backend="numpy", n_groups=1, wall_time_s=0.0)


def test_pareto_front_dominance():
    rep = _report_from([
        (1.0, 1.0, 1.0, True),     # kept
        (2.0, 2.0, 2.0, True),     # dominated by p0
        (0.5, 3.0, 1.0, True),     # kept: better E, worse T
        (1.0, 1.0, 1.0, True),     # tie with p0: both survive
        (0.1, 0.1, 0.1, False),    # infeasible: filtered by default
    ])
    front = rep.pareto_front()
    assert [r["name"] for r in front] == ["p0", "p2", "p3"]
    assert [r["name"] for r in rep.pareto_front(feasible_only=False)] == \
        ["p4"]
    row, _ = rep.best()
    assert row["name"] == "p2"
    with pytest.raises(ValueError, match="no feasible"):
        _report_from([(1, 1, 1, False)]).best()


def test_sweep_report_csv(tmp_path):
    rep = _report_from([(1.0, 2.0, 3.0, True)])
    rep = dataclasses.replace(
        rep, rows=({**rep.rows[0], "Kn": (1, 2, 3)},))
    path = rep.to_csv(str(tmp_path / "s.csv"))
    lines = open(path).read().splitlines()
    assert lines[0].split(",")[:2] == ["name", "E"]
    assert "1|2|3" in lines[1]


def test_sweep_over_n_expands_the_system():
    """The special axis "N" ceil-tiles the edge system and the constants,
    as the JAX package's expand_grid does."""
    from repro_torch.api.sweep import expand_grid
    from repro.api.sweep import expand_grid as r_expand_grid
    got = expand_grid(scenario(P), {"N": [2, 6]})
    ref = r_expand_grid(scenario(R), {"N": [2, 6]})
    for a, b in zip(ref, got):
        assert a.system.N == b.system.N and a.consts.N == b.consts.N
        assert np.array_equal(a.system.rn, b.system.rn)
