"""Decoder-only LM over the dense attention block stack
(``repro/models/lm.py``), in PyTorch.

The layer list (``cfg.layer_types``) is segmented into maximal runs of equal
block type; each segment's per-layer params are stacked on a leading axis,
the JAX package's tree exactly (``params["segments"][i]`` holds leaves of
shape ``(count, ...)``, caches ``{"k", "v", "pos", "idx"}`` likewise), so
:func:`params_from_jax` is a copy.  Where the reference scans a segment,
this runs a Python loop over its layers.

:func:`loss_train` is the causal-LM cross entropy the federated runtime
differentiates; its backward is autograd through the same forward (no
remat: ``jax.checkpoint`` in the reference changes memory, not a number).
The vocab projection is chunked over ``LOSS_CHUNK`` positions as in the
reference, so at full width one chunk's f32 logits are 512 x vocab.

Carried block types: ``attn`` (full attention + gated MLP: qwen3, mistral,
llama3), ``local`` (sliding window) and ``global`` (gemma3).  The others —
``attn_moe``, ``mamba2``, ``shared_attn``, ``mlstm``, ``slstm`` — raise
:class:`NotImplementedError` (ROADMAP.md, Queue 1, item 10).  Decode
updates the caches in place and returns them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import not_ported, resolve_device
from ..configs.base import ArchConfig
from . import blocks as B

__all__ = ["init_params", "params_from_jax", "loss_train", "prefill",
           "decode_step", "init_caches", "forward_hidden"]

#: block types that are one attention block + gated MLP; the window adds
#: one term to the mask and a ring-buffer cursor
DENSE_TYPES = ("attn", "local", "global")
LOSS_CHUNK = 512  # sequence chunk for the vocab-projection loss


def _check_btype(btype: str):
    if btype not in DENSE_TYPES:
        raise not_ported(f"block type {btype!r}", 10)


def _layer(tree, j: int):
    """Layer ``j`` of a stacked segment tree (views, so in-place updates of
    a cache reach the stack)."""
    if isinstance(tree, dict):
        return {k: _layer(v, j) for k, v in tree.items()}
    return tree[j]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _block_init(generator, cfg: ArchConfig, dtype, count: int):
    D, dev, lead = cfg.d_model, generator.device, (count,)
    return {"ln1": torch.ones(count, D, dtype=dtype, device=dev),
            "attn": B.attn_init(generator, cfg, dtype, lead),
            "ln2": torch.ones(count, D, dtype=dtype, device=dev),
            "mlp": B.mlp_init(generator, cfg, dtype=dtype, lead=lead)}


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> dict:
    """Fresh parameters with the JAX package's distributions (N(0, 1/d_in)
    projections, N(0, 1/D) embedding, unit norms), drawn from ``generator``
    on its device; with none, a generator on the card seeded 0 (raises with
    no card)."""
    if generator is None:
        generator = torch.Generator(
            device=resolve_device("cuda")).manual_seed(0)
    for btype, _ in cfg.segments:
        _check_btype(btype)
    dev = generator.device
    params = {
        "embed": torch.randn(cfg.vocab, cfg.d_model, generator=generator,
                             device=dev).div_(np.sqrt(cfg.d_model)).to(dtype),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "segments": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = B.dense_init(generator, cfg.d_model, cfg.vocab,
                                         dtype)
    for _, count in cfg.segments:
        params["segments"].append(_block_init(generator, cfg, dtype, count))
    return params


def params_from_jax(params, device="cuda"):
    """The JAX package's parameter (or cache) tree, as NumPy arrays, as
    this package's tensors on ``device`` (the card unless the caller asks
    for the CPU): the same tree and shapes, so this is a copy."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.tensor(np.asarray(t), device=dev)
    return conv(params)


# ---------------------------------------------------------------------------
# block application (prefill path)
# ---------------------------------------------------------------------------
def _block_apply(p, h, btype, cfg: ArchConfig, positions):
    _check_btype(btype)
    window = cfg.window if btype == "local" else None
    a, kv = B.attn_apply(p["attn"], B.rmsnorm(h, p["ln1"], cfg.norm_eps),
                         cfg, positions, window=window)
    h = h + a
    y = B.mlp_apply(p["mlp"], B.rmsnorm(h, p["ln2"], cfg.norm_eps))
    return h + y, kv


def _unbind(tree, count: int) -> list:
    """The ``count`` layers of a stacked segment tree, unbound once: the
    backward is then one stack a leaf, where indexing each layer would add
    a zeroed copy of the whole stack a layer."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, count) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(count)]
    return torch.unbind(tree, 0)


def forward_hidden(params, cfg: ArchConfig, h, positions):
    """Run the block stack on embeddings h: (B, S, D) -> (h, aux_loss); the
    aux loss is 0 (no carried block type has one)."""
    for (btype, count), seg_p in zip(cfg.segments, params["segments"]):
        for p in _unbind(seg_p, count):
            h, _ = _block_apply(p, h, btype, cfg, positions)
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _embed(params, cfg: ArchConfig, batch):
    if "patch_embeds" in batch:
        raise not_ported("VLM patch embeddings (qwen2-vl)", 10)
    return params["embed"][batch["tokens"].long()]


def _positions(cfg: ArchConfig, batch):
    if cfg.mrope:
        raise not_ported("M-RoPE positions (qwen2-vl)", 10)
    tokens = batch["tokens"]
    Bt, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(Bt, S)


def _logits(params, cfg: ArchConfig, h):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def _ce_sum(h, head, labels):
    """Summed cross entropy of positions h (..., D) against labels: the
    logits in h's dtype, then log-softmax in f32, as the reference."""
    logits = (h @ head).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).sum()


def loss_train(params, cfg: ArchConfig, batch, aux_weight: float = 0.01):
    """Causal-LM cross entropy, sequence-chunked vocab projection:
    ``total / (B * S) + aux_weight * aux`` (a scalar f32 tensor that
    autograd differentiates)."""
    h = _embed(params, cfg, batch)
    pos = _positions(cfg, batch)
    h, aux = forward_hidden(params, cfg, h, pos)
    labels = batch["labels"]
    Bt, S, _ = h.shape
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    n_chunks = max(1, S // LOSS_CHUNK)
    if S % LOSS_CHUNK == 0 and n_chunks > 1:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n_chunks):
            sl = slice(i * LOSS_CHUNK, (i + 1) * LOSS_CHUNK)
            total = total + _ce_sum(h[:, sl], head, labels[:, sl])
    else:
        total = _ce_sum(h, head, labels)
    return total / (Bt * S) + aux_weight * aux


# ---------------------------------------------------------------------------
# caches / decode
# ---------------------------------------------------------------------------
def init_caches(cfg: ArchConfig, batch: int, length: int,
                dtype=torch.bfloat16, device="cuda"):
    """One stacked cache dict per segment, leaves ``(count, ...)``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    caches = []
    for btype, count in cfg.segments:
        _check_btype(btype)
        C = min(cfg.window, length) if btype == "local" else length
        caches.append(B.make_cache(cfg, batch, C, dtype=dtype, device=dev,
                                   lead=(count,)))
    return caches


def _block_decode(p, h, cache, btype, cfg: ArchConfig, positions):
    _check_btype(btype)
    window = cfg.window if btype == "local" else None
    a, _ = B.attn_decode(p["attn"], B.rmsnorm(h, p["ln1"], cfg.norm_eps),
                         cfg, positions, cache, window=window)
    h = h + a
    return h + B.mlp_apply(p["mlp"], B.rmsnorm(h, p["ln2"], cfg.norm_eps))


def decode_step(params, cfg: ArchConfig, token, caches, pos):
    """One decode step.  token: (B, 1) int; pos: (B, 1) int positions.

    Returns (logits (B, vocab), caches), the caches updated in place."""
    h = params["embed"][token.long()]
    for (btype, count), seg_p, cache in zip(cfg.segments, params["segments"],
                                            caches):
        for j in range(count):
            h = _block_decode(_layer(seg_p, j), h, _layer(cache, j), btype,
                              cfg, pos)
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], caches


def prefill(params, cfg: ArchConfig, batch, cache_len: Optional[int] = None,
            cache_dtype=torch.bfloat16):
    """Full-sequence forward returning last-token logits + populated caches
    (on the device of the tokens)."""
    h = _embed(params, cfg, batch)
    pos = _positions(cfg, batch)
    Bt, S, _ = h.shape
    cache_len = cache_len or S
    caches = []
    for (btype, count), seg_p in zip(cfg.segments, params["segments"]):
        window = cfg.window if btype == "local" else None
        C = min(cache_len, window) if window else cache_len
        cache = B.make_cache(cfg, Bt, C, dtype=cache_dtype, device=h.device,
                             lead=(count,))
        for j in range(count):
            h, (k, v) = _block_apply(_layer(seg_p, j), h, btype, cfg, pos)
            # the last C entries, or the S entries padded to C
            n = min(S, C)
            cache["k"][j, :, :n] = k[:, S - n:].to(cache_dtype)
            cache["v"][j, :, :n] = v[:, S - n:].to(cache_dtype)
            cache["pos"][j, :, :n] = pos[:, S - n:]
            cache["idx"][j] = S % C if window else S
        caches.append(cache)
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h[:, -1:, :])[:, 0], caches
