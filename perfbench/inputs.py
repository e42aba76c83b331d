"""Everything a run feeds the program and the reference, made from the run's
``--seed``: the weights, each round's batch and each round's key words.

Each stream has a seed of its own, derived from the run's seed and the
stream's tags (:func:`derive`), so one leaf or one round's batch can be
made again alone.  Weights and batches are drawn on the run's device by a
``torch.Generator`` there, one call a leaf; the reference makes them again
after the window from the same seeds."""
from __future__ import annotations

import hashlib
import importlib

import numpy as np
import torch

from .reference.tree import leaves, unflatten


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed for the stream ``tags`` of run ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def reference_model(cfg: dict):
    """The plain reference module that ``cfg["reference"]`` names."""
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def param_spec(cfg: dict) -> dict:
    return reference_model(cfg).param_spec(cfg)


def make_leaf(leaf, seed: int, index: int, device, dtype=torch.float32):
    """Leaf ``index`` of the weights of run ``seed``: N(0, std^2) drawn in
    f32 on ``device``, or ones, in ``dtype``."""
    if leaf.std is None:
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights", index))
    w = torch.randn(leaf.shape, generator=gen, device=device,
                    dtype=torch.float32).mul_(leaf.std)
    return w.to(dtype)


def make_weights(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The whole parameter tree of run ``seed``, in ``dtype``."""
    spec = param_spec(cfg)
    return unflatten(spec, [make_leaf(l, seed, i, device, dtype)
                            for i, l in enumerate(leaves(spec))])


def round_batch(cfg: dict, job: dict, seed: int, r: int, device) -> dict:
    """Round ``r``'s batch, leaves (fl, K_max, B, ...): uniform tokens
    with labels the next tokens; for an encoder-decoder also the frames,
    N(0, 1) rounded to bf16."""
    fl, K = job["fl"], max(job["Kn"])
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "tokens", r))
    toks = torch.randint(0, cfg["vocab_size"],
                         (fl, K, job["batch"], job["seq"] + 1),
                         generator=gen, device=device, dtype=torch.int64)
    toks = toks.to(torch.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if job.get("frames"):
        gen.manual_seed(derive(seed, "frames", r))
        frames = torch.randn((fl, K, job["batch"], job["frames"],
                              cfg["d_model"]), generator=gen, device=device,
                             dtype=torch.float32)
        batch["frames"] = frames.to(torch.bfloat16)
    return batch


def key_seed(seed: int, r: int) -> int:
    """The seed the trainer's ``run`` takes for round ``r``: its key words
    are the first draw of ``numpy.random.default_rng`` on it."""
    return derive(seed, "keys", r)


def round_words(seed: int, r: int, fl: int) -> np.ndarray:
    """Round ``r``'s key words, (fl + 1, 2) uint32: the workers' rows, then
    the server's; the trainer draws them so from :func:`key_seed`."""
    rng = np.random.default_rng(key_seed(seed, r))
    return rng.integers(0, 1 << 32, size=(fl + 1, 2),
                        dtype=np.uint64).astype(np.uint32)
