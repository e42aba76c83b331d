"""repro_torch.train — the federated LM trainer (``repro/train``):
:class:`GenQSGDTrainer` over the runtime of :mod:`repro_torch.fed`, and
checkpoints in the JAX package's file format."""
from .checkpoint import load, save
from .trainer import GenQSGDTrainer, TrainState, round_comm_bits

__all__ = ["GenQSGDTrainer", "TrainState", "round_comm_bits", "save", "load"]
