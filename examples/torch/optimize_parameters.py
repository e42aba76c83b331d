"""The optimization framework as a standalone tool (the PyTorch port's
twin of ``examples/optimize_parameters.py``): solve the paper's Problems
2/9 for any (T_max, C_max, system) and compare against PM-SGD / FedAvg /
PR-SGD parameterizations — all through the repro_torch.api facade.

Every comparison is one ``sweep_scenarios`` call: the scenarios group by
(m, family) structure and each group solves through the fused GIA on the
card (``--backend auto``; ``torch`` is the batched GP solve an iteration,
``numpy`` the scalar solver; ``repro``'s ``jnp`` engines are refused).
``--pareto`` additionally sweeps the C_max budget axis and prints the
non-dominated (E, T, C) frontier.

    PYTHONPATH=src python examples/torch/optimize_parameters.py --cmax 0.25
    PYTHONPATH=src python examples/torch/optimize_parameters.py --pareto
    PYTHONPATH=src python examples/torch/optimize_parameters.py --h100
"""
import argparse

from repro_torch.api import (ConstantRule, EdgeSystem, MLProblemConstants,
                             Scenario, sweep_scenarios)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cmax", type=float, default=0.25)
    ap.add_argument("--tmax", type=float, default=1e5)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "numpy"],
                    help="GP solver backend")
    ap.add_argument("--device", default="cuda", help="the card or cpu")
    ap.add_argument("--pareto", action="store_true",
                    help="sweep the C_max axis too and print the Pareto "
                         "front of (E, T, C)")
    ap.add_argument("--h100", action="store_true",
                    help="use the H100 fleet cost model instead of the "
                         "paper's Sec.-VII edge system")
    args = ap.parse_args(argv)

    if args.h100:
        sys_ = EdgeSystem.h100_fleet(dim=405_000_000_000, n_groups=2,
                                     chips_per_group=256, s0=1024, sn=1024,
                                     flops_per_sample_step=6 * 405e9 * 4096)
        consts = MLProblemConstants(L=0.05, sigma=4.0, G=5.0, f_gap=3.0, N=2)
        args.cmax, args.tmax = 0.5, 3 * 24 * 3600.0
    else:
        from repro_torch.api import MNISTTask
        sys_ = EdgeSystem.paper_sec_vii(dim=MNISTTask.dim)
        consts = MLProblemConstants(L=0.084, sigma=33.18, G=33.63,
                                    f_gap=2.3, N=10)

    def scenario(family="genqsgd", step=None):
        return Scenario(system=sys_, consts=consts, T_max=args.tmax,
                        C_max=args.cmax, family=family, step=step)

    table = [("GenQSGD (opt)", scenario()),
             ("Gen-C g=.01", scenario(step=ConstantRule(0.01))),
             ("PM-SGD", scenario("pm", ConstantRule(0.01))),
             ("PR-SGD", scenario("pr", ConstantRule(0.01)))]
    if not args.h100:
        table.append(("FedAvg", scenario("fa", ConstantRule(0.01))))

    rep = sweep_scenarios([s for _, s in table], names=[n for n, _ in table],
                          backend=args.backend, device=args.device)
    print(f"T_max={args.tmax:.3g}s  C_max={args.cmax}  "
          f"[{rep.backend} backend, {rep.n_groups} structure groups, "
          f"{rep.wall_time_s:.1f}s]")
    print(f"{'algorithm':14s} {'K0':>7s} {'Kn':>5s} {'B':>5s} "
          f"{'gamma':>9s} {'E':>11s} {'T':>10s} {'C':>7s}  feasible")
    for row in rep:
        print(f"{row['name']:14s} {row['K0']:7d} {row['Kn'][0]:5d} "
              f"{row['B']:5d} {row['gamma']:9.4g} {row['E']:11.4g} "
              f"{row['T']:10.4g} {row['C']:7.4g}  {row['feasible']}")

    if args.pareto:
        grid = [args.cmax * f for f in (0.8, 0.9, 1.0, 1.2, 1.6, 2.4)]
        front = scenario().sweep(over={"cmax": grid}, backend=args.backend,
                                 device=args.device).pareto_front()
        print(f"\nPareto front over C_max in {[round(c, 4) for c in grid]} "
              f"(jointly optimized step size):")
        for row in front:
            print(f"  C_max={row['C_max']:<8.4g} E={row['E']:<12.4g} "
                  f"T={row['T']:<12.4g} C={row['C']:.4g}")
    return rep


if __name__ == "__main__":
    main()
