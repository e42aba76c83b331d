"""Faults planted in the port's training round, to show that the
correctness check catches each kind a training cell can have.  Each is a
context manager that patches the program while it is open; none is used by
a benchmark run.

  ``unchanged``     the round returns x̂ unchanged (its metrics still
                    computed);
  ``half_batch``    each local step sees the first half of its batch rows,
                    its loss the mean over those;
  ``no_exchange``   the workers' uploads are not exchanged: every slot of
                    the gathered payload (and of the gathered losses) holds
                    worker 0's;
  ``leaf_dropped``  one answer altered where it is made: the server's apply
                    of the last leaf in leaf order keeps x̂'s values.

The control is not a patch: the program's own bf16 master-weight path (the
weights handed to it in bf16), one precision below the f32 masters the
configurations state."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def unchanged(n_leaves: int):
    from repro_torch.fed import runtime

    def make(orig):
        def aggregate_apply(fed, transport, x_hat, *args, **kwargs):
            _, metrics = orig(fed, transport, x_hat, *args, **kwargs)
            return x_hat, metrics
        return aggregate_apply
    return _patched(runtime, "aggregate_apply", make)


@contextlib.contextmanager
def half_batch(n_leaves: int):
    from repro_torch.models import lm, whisper

    def make(orig):
        def loss_train(params, cfg, batch, *args, **kwargs):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return orig(params, cfg, half, *args, **kwargs)
        return loss_train
    with _patched(lm, "loss_train", make), \
            _patched(whisper, "loss_train", make):
        yield


def no_exchange(n_leaves: int):
    import torch
    from repro_torch.fed.transport import LocalTransport

    def make(orig):
        def gather(self, parts):
            parts = list(parts)
            return torch.stack([parts[0]] * len(parts))
        return gather
    return _patched(LocalTransport, "gather", make)


def leaf_dropped(n_leaves: int):
    from repro_torch.fed import runtime
    calls = [0]

    def make(orig):
        def decode_apply_cuda(x, *args, **kwargs):
            calls[0] += 1
            if calls[0] % n_leaves == 0:
                return x.clone()
            return orig(x, *args, **kwargs)
        return decode_apply_cuda
    return _patched(runtime, "decode_apply_cuda", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "leaf_dropped": leaf_dropped}
