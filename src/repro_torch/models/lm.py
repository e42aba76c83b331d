"""Decoder-only LM over heterogeneous block stacks (``repro/models/lm.py``),
in PyTorch.

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
llama3), ``local`` (sliding window) and ``global`` (gemma3), ``attn_moe``
(full attention + the MoE MLP of :mod:`.moe`: olmoe, phi3.5-moe; each
layer adds its router's load-balance loss to the aux loss), ``mamba2`` (the
SSD mixer of :mod:`.mamba2`) and ``shared_attn`` (zamba2: one attention
block and MLP in ``params["shared"]``, applied by every such layer with its
own ``ln1``/``ln2`` and its own KV cache), ``mlstm`` and ``slstm`` (the
xLSTM blocks of :mod:`.xlstm`).  A mamba2 layer's cache is its state
``{"h", "conv"}``, both f32 whatever the KV cache's type: the reference's
decode step promotes the conv tail to the activations' f32, so its leaf is
f32 from the first step on.  An xLSTM layer's cache is its state, f32
(``{"C", "n", "m"}`` for mLSTM, ``{"c", "n", "h", "m"}`` for sLSTM), as
the reference's.  A mamba2 layer's decode runs inside the profiler range
``mamba2.decode``, an xLSTM layer's inside ``xlstm.mlstm_decode`` or
``xlstm.slstm_decode``.  Decode updates the caches in place and returns
them.  A VLM (qwen2-vl) batch carries ``patch_embeds`` (B, n_patch, D),
which replace the first n_patch token embeddings, and ``positions3``
(3, B, S) for M-RoPE; decode broadcasts its (B, 1) positions to the three
streams.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..obs.trace import device_range
from . import blocks as B
from . import mamba2 as M2
from . import moe as MOE
from . import xlstm as XL

__all__ = ["init_params", "abstract_params", "params_from_jax", "loss_train",
           "prefill", "decode_step", "init_caches", "forward_hidden"]

#: block types that are one attention block + gated MLP; the window adds
#: one term to the mask and a ring-buffer cursor
DENSE_TYPES = ("attn", "local", "global")
#: block types whose cache is a recurrent state, not a KV cache
STATE_TYPES = ("mamba2", "mlstm", "slstm")
CARRIED_TYPES = DENSE_TYPES + ("attn_moe", "shared_attn") + STATE_TYPES
LOSS_CHUNK = 512  # sequence chunk for the vocab-projection loss


def _check_btype(btype: str):
    if btype not in CARRIED_TYPES:
        raise ValueError(f"unknown block type {btype!r}")


def _layer(tree, j: int):
    """Layer ``j`` of a stacked segment tree (views, so in-place updates of
    a cache reach the stack)."""
    if isinstance(tree, dict):
        return {k: _layer(v, j) for k, v in tree.items()}
    return tree[j]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _block_init(generator, btype: str, cfg: ArchConfig, dtype, count: int):
    D, dev, lead = cfg.d_model, generator.device, (count,)

    def norm():
        return torch.ones(count, D, dtype=dtype, device=dev)
    if btype == "mamba2":
        return {"ln1": norm(),
                "mamba": M2.mamba2_init(generator, cfg, dtype, lead)}
    if btype == "mlstm":
        return {"ln1": norm(),
                "mlstm": XL.mlstm_init(generator, cfg, dtype, lead)}
    if btype == "slstm":
        return {"ln1": norm(),
                "slstm": XL.slstm_init(generator, cfg, dtype, lead)}
    p = {"ln1": norm(), "ln2": norm()}
    if btype == "shared_attn":      # the body lives in params["shared"]
        return p
    p["attn"] = B.attn_init(generator, cfg, dtype, lead)
    if btype == "attn_moe":
        p["moe"] = MOE.moe_init(generator, cfg, dtype, lead)
    else:
        p["mlp"] = B.mlp_init(generator, cfg, dtype=dtype, lead=lead)
    return p


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
    if any(t == "shared_attn" for t, _ in cfg.segments):
        params["shared"] = {"attn": B.attn_init(generator, cfg, dtype),
                            "mlp": B.mlp_init(generator, cfg, dtype=dtype)}
    for btype, count in cfg.segments:
        params["segments"].append(_block_init(generator, btype, cfg, dtype,
                                              count))
    return params


def fake_init(init, cfg: ArchConfig, dtype, mode=None) -> dict:
    """``init(cfg, generator, dtype=dtype)`` under a fake-tensor mode
    (``mode``, a fresh ``FakeTensorMode`` by default): every leaf a
    ``FakeTensor`` on the CPU with its shape and dtype, nothing allocated.
    The generator is a CPU one (``torch.Generator(device="meta")`` raises)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with mode if mode is not None else FakeTensorMode():
        return init(cfg, torch.Generator(device="cpu").manual_seed(0),
                    dtype=dtype)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16, mode=None) -> dict:
    """The parameter tree's shapes and dtypes with nothing allocated
    (``repro``'s ``jax.eval_shape`` of ``init_params``): fake tensors made
    under ``mode`` (see :func:`fake_init`)."""
    return fake_init(init_params, cfg, dtype, mode)


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
def _block_apply(p, h, btype, cfg: ArchConfig, positions, shared,
                 return_state: bool = False):
    """One block on h: (B, S, D) -> (h, aux, cache entry): aux the router's
    load-balance loss of an ``attn_moe`` block (else None); the entry (k, v)
    of an attention block, the recurrent state of a mamba2 or xLSTM block
    under ``return_state`` (else None)."""
    _check_btype(btype)
    if btype in STATE_TYPES:
        apply, key = _STATE_APPLY[btype]
        x = B.rmsnorm(h, p["ln1"], cfg.norm_eps)
        if return_state:
            y, state = apply(p[key], x, cfg, return_state=True)
            return h + y, None, state
        return h + apply(p[key], x, cfg), None, None
    window = cfg.window if btype == "local" else None
    body = shared if btype == "shared_attn" else p
    a, kv = B.attn_apply(body["attn"], B.rmsnorm(h, p["ln1"], cfg.norm_eps),
                         cfg, positions, window=window)
    h = h + a
    x2 = B.rmsnorm(h, p["ln2"], cfg.norm_eps)
    aux = None
    if btype == "attn_moe":
        y, probs = MOE.moe_apply(p["moe"], x2, cfg)
        aux = MOE.router_aux_loss(probs)
    else:
        y = B.mlp_apply(body["mlp"], x2)
    return h + y, aux, kv


#: a recurrent block's mixer: block type -> (apply, its params' key)
_STATE_APPLY = {"mamba2": (M2.mamba2_apply, "mamba"),
                "mlstm": (XL.mlstm_apply, "mlstm"),
                "slstm": (XL.slstm_apply, "slstm")}


def _unbind(tree, count: int) -> list:
    """The ``count`` layers of a stacked segment tree, unbound once: the
    backward is then one stack a leaf, where indexing each layer would add
    a zeroed copy of the whole stack a layer."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, count) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(count)]
    return torch.unbind(tree, 0)


def forward_hidden(params, cfg: ArchConfig, h, positions):
    """Run the block stack on embeddings h: (B, S, D) -> (h, aux_loss): the
    aux loss (f32) sums the router losses of the ``attn_moe`` layers."""
    shared = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for (btype, count), seg_p in zip(cfg.segments, params["segments"]):
        for p in _unbind(seg_p, count):
            h, a, _ = _block_apply(p, h, btype, cfg, positions, shared)
            if a is not None:
                aux = aux + a
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return h, aux


def _embed(params, cfg: ArchConfig, batch):
    h = params["embed"][batch["tokens"].long()]
    if "patch_embeds" in batch:     # VLM: overwrite the image-token span
        pe = batch["patch_embeds"]
        h = torch.cat([pe.to(h.dtype), h[:, pe.shape[1]:]], dim=1)
    return h


def _positions(cfg: ArchConfig, batch):
    if cfg.mrope:
        return batch["positions3"]
    tokens = batch["tokens"]
    Bt, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(Bt, S)


def _logits(params, cfg: ArchConfig, h):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def _ce_sum(h, head, labels):
    """Summed cross entropy of positions h (..., D) against labels: the
    logits in the operands' promoted type, then log-softmax in f32, as the
    reference."""
    logits = B.matmul(h, head).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).sum()


def _ce_total(h, head, labels):
    """Summed cross entropy of h (B, S, D) against labels (B, S), the vocab
    projection chunked over ``LOSS_CHUNK`` positions where that splits S
    into two or more chunks (an f32 scalar)."""
    S = h.shape[1]
    n_chunks = max(1, S // LOSS_CHUNK)
    if S % LOSS_CHUNK == 0 and n_chunks > 1:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n_chunks):
            sl = slice(i * LOSS_CHUNK, (i + 1) * LOSS_CHUNK)
            total = total + _ce_sum(h[:, sl], head, labels[:, sl])
        return total
    return _ce_sum(h, head, labels)


def loss_train(params, cfg: ArchConfig, batch, aux_weight: float = 0.01):
    """Causal-LM cross entropy, sequence-chunked vocab projection:
    ``total / (B * S) + aux_weight * aux`` (a scalar f32 tensor that
    autograd differentiates)."""
    h = _embed(params, cfg, batch)
    pos = _positions(cfg, batch)
    h, aux = forward_hidden(params, cfg, h, pos)
    Bt, S, _ = h.shape
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _ce_total(h, head, batch["labels"]) / (Bt * S) + aux_weight * aux


# ---------------------------------------------------------------------------
# caches / decode
# ---------------------------------------------------------------------------
def init_caches(cfg: ArchConfig, batch: int, length: int,
                dtype=torch.bfloat16, device="cuda"):
    """One stacked cache dict per segment, leaves ``(count, ...)``, on
    ``device`` (the card unless the caller asks for the CPU): a KV cache of
    an attention segment in ``dtype``, the SSM state of a mamba2 one in f32
    (the type of the reference's state after its first decode step), the
    state of an xLSTM one in f32 (the reference's)."""
    dev = resolve_device(device)
    caches = []
    for btype, count in cfg.segments:
        _check_btype(btype)
        if btype == "mamba2":
            caches.append(M2.make_ssm_state(cfg, batch, torch.float32, dev,
                                            lead=(count,)))
            continue
        if btype in ("mlstm", "slstm"):
            make = XL.make_mlstm_state if btype == "mlstm" \
                else XL.make_slstm_state
            caches.append(make(cfg, batch, dev, lead=(count,)))
            continue
        C = min(cfg.window, length) if btype == "local" else length
        caches.append(B.make_cache(cfg, batch, C, dtype=dtype, device=dev,
                                   lead=(count,)))
    return caches


#: a recurrent block's decode: block type -> (decode, its params' key,
#: its profiler range)
_STATE_DECODE = {"mamba2": (M2.mamba2_decode, "mamba", "mamba2.decode"),
                 "mlstm": (XL.mlstm_decode, "mlstm", "xlstm.mlstm_decode"),
                 "slstm": (XL.slstm_decode, "slstm", "xlstm.slstm_decode")}


def _block_decode(p, h, cache, btype, cfg: ArchConfig, positions, shared):
    _check_btype(btype)
    if btype in STATE_TYPES:
        decode, key, label = _STATE_DECODE[btype]
        with device_range(label):
            y, _ = decode(p[key], B.rmsnorm(h, p["ln1"], cfg.norm_eps), cfg,
                          cache)
        return h + y
    window = cfg.window if btype == "local" else None
    body = shared if btype == "shared_attn" else p
    a, _ = B.attn_decode(body["attn"], B.rmsnorm(h, p["ln1"], cfg.norm_eps),
                         cfg, positions, cache, window=window)
    h = h + a
    x2 = B.rmsnorm(h, p["ln2"], cfg.norm_eps)
    if btype == "attn_moe":
        return h + MOE.moe_apply(p["moe"], x2, cfg)[0]
    return h + B.mlp_apply(body["mlp"], x2)


def decode_step(params, cfg: ArchConfig, token, caches, pos):
    """One decode step.  token: (B, 1) int; pos: (B, 1) int positions
    (broadcast to the three M-RoPE streams under ``cfg.mrope``).

    Returns (logits (B, vocab), caches), the caches updated in place."""
    h = params["embed"][token.long()]
    if cfg.mrope:
        pos = pos[None].expand(3, *pos.shape)
    shared = params.get("shared")
    for (btype, count), seg_p, cache in zip(cfg.segments, params["segments"],
                                            caches):
        for j in range(count):
            h = _block_decode(_layer(seg_p, j), h, _layer(cache, j), btype,
                              cfg, pos, shared)
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], caches


def prefill(params, cfg: ArchConfig, batch, cache_len: Optional[int] = None,
            cache_dtype=torch.bfloat16):
    """Full-sequence forward returning last-token logits + populated caches
    (on the device of the tokens).  A recurrent layer's cache is the state
    its forward returns: for mamba2 h in f32 and the conv tail in the
    activations' type (the reference's), for xLSTM f32 leaves.  The cache
    positions are the tokens' (stream 0 under M-RoPE)."""
    h = _embed(params, cfg, batch)
    pos = _positions(cfg, batch)
    tok_pos = pos[0] if cfg.mrope else pos
    Bt, S, _ = h.shape
    cache_len = cache_len or S
    shared = params.get("shared")
    caches = []
    for (btype, count), seg_p in zip(cfg.segments, params["segments"]):
        if btype in STATE_TYPES:
            states = []
            for j in range(count):
                h, _, st = _block_apply(_layer(seg_p, j), h, btype, cfg, pos,
                                        shared, return_state=True)
                states.append(st)
            caches.append({k: torch.stack([st[k] for st in states])
                           for k in states[0]})
            continue
        window = cfg.window if btype == "local" else None
        C = min(cache_len, window) if window else cache_len
        cache = B.make_cache(cfg, Bt, C, dtype=cache_dtype, device=h.device,
                             lead=(count,))
        for j in range(count):
            h, _, (k, v) = _block_apply(_layer(seg_p, j), h, btype, cfg, pos,
                                        shared)
            # the last C entries, or the S entries padded to C
            n = min(S, C)
            cache["k"][j, :, :n] = k[:, S - n:].to(cache_dtype)
            cache["v"][j, :, :n] = v[:, S - n:].to(cache_dtype)
            cache["pos"][j, :, :n] = tok_pos[:, S - n:]
            cache["idx"][j] = S % C if window else S
        caches.append(cache)
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h[:, -1:, :])[:, 0], caches
