"""End-to-end driver (the PyTorch port's twin of
``examples/train_lm_federated.py``): federated training of a small LM with
the GenQSGD runtime, fl = 2 workers trained in turn on one card (the
reference lays them on a simulated 8-device mesh; fsdp and tp have no
counterpart here), the workers' uploads and the server's multicast encoded
by the QSGD kernels (K1, K2) and applied by K3 (K3b with ``--bucket``).

The run is parameterized through a repro_torch.api :class:`Plan` — the
same object ``Scenario.optimize`` produces — so the FedConfig derives from
one validated source of truth (a hand-built Plan here, since the demo
picks its knobs from the command line rather than from the optimizer).

    PYTHONPATH=src python examples/torch/train_lm_federated.py --rounds 20
    PYTHONPATH=src python examples/torch/train_lm_federated.py --full

--full uses the ~100M config; the default is a ~10M variant.
"""
import argparse

from repro_torch.api import ConstantRule, GenQSGDTrainer, Plan, round_comm_bits
from repro_torch.compress import RUNTIME_WIRES, wire_max_s
from repro_torch.configs.base import ArchConfig
from repro_torch.data.federated import round_batches
from repro_torch.data.synthetic import token_batches
from repro_torch.fed import LocalTransport, tree_leaves
from repro_torch.models import lm


def small_cfg(full: bool) -> ArchConfig:
    if full:  # ~100M params
        return ArchConfig(name="lm-100m", family="dense", citation="example",
                          n_layers=12, d_model=768, n_heads=12, n_kv=4,
                          d_ff=3072, vocab=8192, d_head=64)
    return ArchConfig(name="lm-10m", family="dense", citation="example",
                      n_layers=4, d_model=256, n_heads=4, n_kv=2,
                      d_ff=1024, vocab=2048, d_head=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8, help="per-worker batch")
    ap.add_argument("--k-local", type=int, default=2)
    ap.add_argument("--wire", default="int8", choices=list(RUNTIME_WIRES))
    ap.add_argument("--s", type=int, default=None,
                    help="quantization parameter s0=sn (default: 64, "
                         "clamped to the wire's cap)")
    ap.add_argument("--bucket", type=int, default=None,
                    help="per-bucket-norm quantization bucket size")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="the card or cpu")
    args = ap.parse_args(argv)
    s_q = args.s if args.s is not None else min(64,
                                                wire_max_s(args.wire) or 64)

    cfg = small_cfg(args.full)
    fl = 2
    plan = Plan.manual(K0=args.rounds, Kn=(args.k_local,) * fl, B=args.batch,
                       step_rule=ConstantRule(0.01), s0=s_q, sn=s_q,
                       q_dim=args.bucket)
    fed = plan.to_fed_config(wire=args.wire)
    trainer = GenQSGDTrainer(lm, cfg, fed, LocalTransport(fl),
                             plan.step_rule, args.ckpt, args.device)
    state = trainer.init(0)
    n_params = sum(l.numel() for l in tree_leaves(state.params))
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params | "
          f"fl={fl} on {trainer.device} | wire={args.wire} | "
          f"{round_comm_bits(fed, n_params)/8e6:.1f} MB/round")

    stream = token_batches(seed=0, batch=args.batch, seq=args.seq,
                           vocab=cfg.vocab)
    batches = round_batches(stream, fl, fed.K_max)
    state = trainer.run(state, batches, 1, n_rounds=args.rounds,
                        log_every=max(1, args.rounds // 10),
                        ckpt_every=0 if not args.ckpt else args.rounds // 2)
    first, last = state.history[0]["loss"], state.history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} over {args.rounds} rounds "
          f"({'improved' if last < first else 'NOT improved'})")
    return state


if __name__ == "__main__":
    main()
