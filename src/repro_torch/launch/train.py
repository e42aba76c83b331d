"""Training launcher: GenQSGD federated training for any registered
decoder-only arch (``repro/launch/train.py``).

The fl workers train in turn on one card through
:class:`~repro_torch.fed.LocalTransport` (``--device cpu`` runs them on
the CPU).  ``repro``'s ``--fsdp``/``--tp`` shard one worker over a GSPMD
mesh and have no counterpart here (``src/repro_torch/fed/__init__.py``):
they accept 1 and refuse more.  ``repro``'s ``--devices`` (an XLA host
device count) is ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --rounds 20 --fl 2 --wire int8
"""
import argparse

from ..compress import RUNTIME_WIRES, wire_max_s


def default_s(wire: str) -> int:
    """s0 = sn when the command line gives none: 64, within the wire's cap
    (7 on int4)."""
    return min(64, wire_max_s(wire) or 64)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--fl", type=int, default=2)
    ap.add_argument("--fsdp", type=int, default=1,
                    help="no counterpart: one card holds a worker whole")
    ap.add_argument("--tp", type=int, default=1,
                    help="no counterpart: one card holds a worker whole")
    ap.add_argument("--k-local", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--rule", default="C", choices=["C", "E", "D"])
    ap.add_argument("--rho", type=float, default=None)
    ap.add_argument("--s0", type=int, default=None,
                    help="server quantizer (default: 64, or 7 on int4)")
    ap.add_argument("--sn", type=int, default=None,
                    help="worker quantizer (default: 64, or 7 on int4)")
    ap.add_argument("--wire", default="f32", choices=list(RUNTIME_WIRES))
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    return ap


def main(argv=None):
    """Parse ``argv`` (the command line by default), train, and return the
    final :class:`~repro_torch.train.trainer.TrainState`."""
    args = parser().parse_args(argv)
    for flag in ("fsdp", "tp"):
        if getattr(args, flag) != 1:
            raise SystemExit(
                f"--{flag} {getattr(args, flag)}: sharding inside a worker "
                f"has no counterpart in the port (src/repro_torch/fed/"
                f"__init__.py:5-14); one card holds a worker whole, so "
                f"--{flag} takes 1")

    from ..core.step_rules import make_rule
    from ..data.federated import round_batches
    from ..data.synthetic import token_batches
    from ..fed import FedConfig, LocalTransport, tree_leaves
    from ..models.registry import get_config, model_api
    from ..train.trainer import GenQSGDTrainer

    cfg = get_config(args.arch, smoke=args.smoke)
    api = model_api(cfg)
    if cfg.encdec:
        raise SystemExit("enc-dec archs train via examples (frames input); "
                         "use a decoder-only arch here")
    s0 = args.s0 if args.s0 is not None else default_s(args.wire)
    sn = args.sn if args.sn is not None else default_s(args.wire)
    fed = FedConfig(n_workers=args.fl, Kn=(args.k_local,) * args.fl,
                    s0=s0, sn=sn, wire=args.wire)
    rule = make_rule(args.rule, args.gamma, args.rho)
    trainer = GenQSGDTrainer(api, cfg, fed, LocalTransport(args.fl), rule,
                             args.ckpt, args.device)
    state = trainer.init(0)
    n_params = sum(l.numel() for l in tree_leaves(state.params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params | mesh "
          f"fl={args.fl} on {trainer.device} | wire={args.wire} "
          f"rule={args.rule}", flush=True)
    stream = token_batches(seed=0, batch=args.batch, seq=args.seq,
                           vocab=cfg.vocab)
    batches = round_batches(stream, args.fl, fed.K_max)
    state = trainer.run(state, batches, 1, n_rounds=args.rounds,
                        log_every=max(1, args.rounds // 10),
                        ckpt_every=(args.rounds // 2 if args.ckpt else 0))
    print(f"[train] done: loss {state.history[0]['loss']:.3f} -> "
          f"{state.history[-1]['loss']:.3f}", flush=True)
    return state


if __name__ == "__main__":
    main()
