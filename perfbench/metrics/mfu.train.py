"""Model FLOP utilization of the round, in %: the model FLOPs of the
round's active local steps (the reference model's ``train_flops``, from
the shapes) over the window's ms a round times the H100's bf16 peak, the
type the local steps compute in."""
from perfbench.roofline import H100


def read(ctx):
    if not ctx.get("flops_per_round") or not ctx.get("round_ms"):
        return None
    return 100.0 * ctx["flops_per_round"] / (
        ctx["round_ms"] * 1e-3 * H100["bf16_flops"])
