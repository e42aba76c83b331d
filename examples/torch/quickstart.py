"""Quickstart on the card: the paper end-to-end through repro_torch.api
(the PyTorch port's twin of ``examples/quickstart.py``).

1. Estimate the ML-problem constants (L, sigma, G) by pre-training probes.
2. Optimize ALL GenQSGD parameters (K_0, K_n, B, gamma) with Algorithm 5.
3. Run GenQSGD (Algorithm 1) with *exactly* the optimized parameters on the
   MNIST-like federated task (QSGD encode and apply as CUDA kernels) and
   compare measured cost against predictions.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu \\
        --max-rounds 20 --probe-iters 24
"""
import argparse

from repro_torch.api import EdgeSystem, MNISTTask, Scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="the card or cpu")
    ap.add_argument("--max-rounds", type=int, default=400,
                    help="cut the run after this many rounds")
    ap.add_argument("--probe-iters", type=int, default=120,
                    help="pre-training iterations of the constants' probe "
                         "(at least its 12 snapshots)")
    args = ap.parse_args(argv)
    task = MNISTTask(device=args.device)

    print("== 1. data + pre-training constants ==")
    consts = task.estimate_constants(N=10, n_iters=args.probe_iters)
    print(f"   L={consts.L:.3g} sigma={consts.sigma:.3g} "
          f"G={consts.G:.3g} f_gap={consts.f_gap:.3g}")

    print("== 2. optimize (K, B, gamma) — Algorithm 5 ==")
    scenario = Scenario(system=EdgeSystem.paper_sec_vii(dim=task.dim),
                        consts=consts, T_max=1e5, C_max=0.25)
    plan = scenario.optimize()
    print("   " + plan.describe())

    print("== 3. run GenQSGD with the optimized parameters ==")
    cut = args.max_rounds
    report = scenario.run(plan, task=task, max_rounds=cut,
                          eval_every=max(1, min(plan.K0, cut) // 8),
                          device=args.device)
    for h in report.history:
        print(f"   round {h['k0']:4d}  test acc {h['test_acc']:.3f}")
    print(report.summary())
    print(f"== done: final accuracy {report.final_metrics['test_acc']:.3f} "
          f"({report.rounds} of {plan.K0} planned rounds) ==")
    return report


if __name__ == "__main__":
    main()
