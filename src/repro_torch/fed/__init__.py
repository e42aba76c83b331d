"""repro_torch.fed — the federated GenQSGD runtime for LM training
(``repro/fed``): :class:`FedConfig`, the round (:func:`make_round_fn`,
composed of :func:`local_train` and :func:`aggregate_apply`) and the
transports that move the fl workers' payloads.

The JAX package lays a round on an (fl, fsdp, tp) device mesh: the fl axis
is the paper's federated workers, fsdp and tp shard one worker's model
inside GSPMD (``repro/fed/sharding.py``).  Here the fl axis is the
transport's (:class:`LocalTransport`: every worker in one process, so one
card trains them in turn; :class:`DistTransport`: one worker a rank of a
``torch.distributed`` group).  fsdp and tp get no counterpart: one H100
holds a qwen3-1.7b worker whole, and the paper's algorithm defines only the
fl axis; sharding inside a worker is a partitioner's concern, like the JAX
package's ``models/shardctx.py``.
"""
from .runtime import (FedConfig, aggregate_apply, local_train, make_round_fn,
                      tree_leaves, tree_unflatten, uniform_like)
from .transport import DistTransport, LocalTransport

__all__ = ["FedConfig", "make_round_fn", "local_train", "aggregate_apply",
           "uniform_like", "tree_leaves", "tree_unflatten", "LocalTransport",
           "DistTransport"]
