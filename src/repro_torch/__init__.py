"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, one slice at a time.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``repro_torch/compress/codec.py`` <-> ``repro/compress/codec.py``, ...) and
imports neither ``jax`` nor ``repro``.  The first slice is the paper's
Sec.-VII closed loop: ``Scenario.optimize()`` (the scalar NumPy GIA/CGP
solver, copied) then ``Scenario.run(plan)`` (GenQSGD, Algorithm 1, in
PyTorch), with the QSGD norm, quantize and dequant-apply as hand-written
CUDA kernels (:mod:`repro_torch.kernels.qsgd`).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card they raise instead of falling back.
"""
from __future__ import annotations

__all__ = ["resolve_device", "same_device"]


def resolve_device(device):
    """``device`` as a :class:`torch.device`; a CUDA device with no card
    raises rather than quietly running on the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} needs a CUDA card and none is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device.  A CUDA device without an
    index is the current card (``torch.cuda.current_device()``, asked only
    when the other one has an index); a CPU device is the CPU whatever its
    index."""
    import torch
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    if a.index is not None and b.index is not None:
        return False
    return (a.index if b.index is None else b.index) == \
        torch.cuda.current_device()
