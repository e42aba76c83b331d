"""How the fl workers' payloads travel: the port's counterpart of the
JAX package's ``shard_map`` collectives over the mesh's ``fl`` axis.

A transport holds some of a round's fl workers in this process (its
``workers``, in order) and moves their per-worker tensors between all of
them.  Three collectives cover the five wires:

  ``gather(parts)``          every worker's tensor, stacked in worker order
                             -> (fl, ...) (the level wires' all-gather);
  ``sum(parts)``             the sum over all workers, added in worker
                             order (the f32 wire's all-reduce, rs_ag's
                             fallback for a leaf fl does not divide);
  ``reduce_scatter(parts)``  each worker's (fl, m) tensor summed over the
                             workers, row r kept by worker r -> one (m,)
                             shard per local worker (rs_ag's first half).

``parts`` is a list with one tensor per local worker.

:class:`LocalTransport` keeps all fl workers in one process (on one card:
the fl axis is a loop and the collectives are stacks and sums).
:class:`DistTransport` runs one worker a rank of a ``torch.distributed``
process group (``all_gather_into_tensor``, ``all_reduce``,
``reduce_scatter_tensor``).  Their sums add the workers in worker order
(for two ranks the backends' sums are that order too), so the two give the
same bits.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["LocalTransport", "DistTransport", "fold"]


def fold(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of ``parts`` added in worker order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class LocalTransport:
    """All ``n_workers`` fl workers in this process."""

    def __init__(self, n_workers: int):
        if n_workers < 1:
            raise ValueError(f"n_workers must be positive, got {n_workers}")
        self.n_workers = int(n_workers)
        self.workers = tuple(range(self.n_workers))

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(parts))

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return fold(parts)

    def reduce_scatter(self, parts: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        return [fold([p[r] for p in parts]) for r in self.workers]


class DistTransport:
    """One fl worker a rank of ``group`` (the default process group when
    None): the rank is the worker."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group
        self.n_workers = dist.get_world_size(group)
        self.workers = (dist.get_rank(group),)

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist
        (t,) = parts
        out = torch.empty(self.n_workers * t.numel(), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(),
                                    group=self.group)
        return out.reshape((self.n_workers,) + tuple(t.shape))

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist
        (t,) = parts
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=self.group)
        return t

    def reduce_scatter(self, parts: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        import torch.distributed as dist
        (t,) = parts
        out = torch.empty(t[0].numel(), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.reshape(-1).contiguous(),
                                   group=self.group)
        return [out.reshape(t.shape[1:])]
