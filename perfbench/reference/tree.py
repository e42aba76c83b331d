"""Parameter trees: nested dicts and lists of tensors, walked with dict keys
sorted, recursively (the leaf order of the program's federated runtime,
which salts each leaf's noise by its index).  A tree's *spec* holds
:class:`Leaf` entries in place of tensors."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its shape and the standard deviation of its normal
    draw (None: a norm's weight, all ones)."""
    shape: Tuple[int, ...]
    std: Optional[float]

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def leaves(tree) -> list:
    """The leaves of ``tree``: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, values) -> object:
    """A tree shaped like ``like`` holding ``values`` in leaf order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out
