"""Whisper-style encoder-decoder backbone (``repro/models/whisper.py``,
arXiv:2212.04356), in PyTorch.

The mel-spectrogram + conv feature extractor is a STUB, as in the
reference: ``batch["frames"]`` holds precomputed frame embeddings (B,
frames, D), capped at ``cfg.max_source_positions`` (1500 = 30 s of audio).
The encoder is bidirectional self-attention with RoPE on the frame index;
the decoder is causal self-attention, cross-attention over the encoder
states and the gated MLP.  The parameter tree is the reference's
(``enc`` and ``dec`` leaves stacked over layers), so ``lm.params_from_jax``
is a copy; where the reference scans the layers, this runs a Python loop.

Decode attends through flash decode (K6, :mod:`repro_torch.kernels.
flash_decode`) twice a layer: the self-attention over its KV cache
(``blocks.attn_decode``) and the cross-attention over the encoder states,
whose K and V are ``enc @ wk``, ``enc @ wv`` recomputed every step as the
reference does (inside the profiler range ``whisper.cross_kv``) and
attended with every frame valid.  Prefill's cross-attention and the encoder
are plain PyTorch.  Products whose operands can differ in type (a bf16
encoder cache against f32 weights; f32 frames and states against the
training runtime's bf16 view) go through ``blocks.matmul``, which promotes
both as ``jnp.matmul`` does.  Decode updates the self-attention caches in
place and returns them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels.flash_decode import flash_decode
from ..obs.trace import device_range
from . import blocks as B
from .lm import _ce_total, _layer, _unbind, fake_init

__all__ = ["init_params", "abstract_params", "encode", "loss_train",
           "prefill", "decode_step", "init_caches"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> dict:
    """Fresh parameters with the reference's distributions (N(0, 1/d_in)
    projections, N(0, 1/D) embedding, unit norms), drawn from ``generator``
    on its device; with none, a generator on the card seeded 0 (raises with
    no card)."""
    if generator is None:
        generator = torch.Generator(
            device=resolve_device("cuda")).manual_seed(0)
    D, dev = cfg.d_model, generator.device

    def norm(*lead):
        return torch.ones(*lead, D, dtype=dtype, device=dev)
    E, L = (cfg.enc_layers,), (cfg.n_layers,)
    embed = torch.randn(cfg.vocab, D, generator=generator,
                        device=dev).div_(np.sqrt(D)).to(dtype)
    enc = {"ln1": norm(*E), "attn": B.attn_init(generator, cfg, dtype, E),
           "ln2": norm(*E), "mlp": B.mlp_init(generator, cfg, dtype, E)}
    dec = {"ln1": norm(*L),
           "self_attn": B.attn_init(generator, cfg, dtype, L),
           "ln_x": norm(*L),
           "cross_attn": B.attn_init(generator, cfg, dtype, L),
           "ln2": norm(*L), "mlp": B.mlp_init(generator, cfg, dtype, L)}
    return {"embed": embed, "enc": enc, "enc_norm": norm(), "dec": dec,
            "final_norm": norm()}


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16, mode=None) -> dict:
    """The parameter tree's shapes and dtypes with nothing allocated
    (``repro``'s ``jax.eval_shape`` of ``init_params``): fake tensors made
    under ``mode`` (see :func:`repro_torch.models.lm.fake_init`)."""
    return fake_init(init_params, cfg, dtype, mode)


# ---------------------------------------------------------------------------
# encoder, cross-attention, decoder stack
# ---------------------------------------------------------------------------
def _arange_pos(Bt: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(Bt, S)


def encode(params, cfg: ArchConfig, frames):
    """frames: (B, F, D) stub conv-frontend output -> encoder states."""
    Bt, F, _ = frames.shape
    pos = _arange_pos(Bt, F, frames.device)
    h = frames
    for pl in _unbind(params["enc"], cfg.enc_layers):
        a, _ = B.attn_apply(pl["attn"], B.rmsnorm(h, pl["ln1"], cfg.norm_eps),
                            cfg, pos, causal=False)
        h = h + a
        h = h + B.mlp_apply(pl["mlp"], B.rmsnorm(h, pl["ln2"], cfg.norm_eps))
    return B.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _cross_kv(p, enc, cfg: ArchConfig):
    """K and V of the encoder states enc (B, F, D): (B, F, KV, dh) each."""
    Bt, F, _ = enc.shape
    k = B.matmul(enc, p["wk"]).reshape(Bt, F, cfg.n_kv, cfg.d_head)
    v = B.matmul(enc, p["wv"]).reshape(Bt, F, cfg.n_kv, cfg.d_head)
    return k, v


def _cross_attend(p, x, enc, cfg: ArchConfig):
    """Cross attention: queries from decoder x, K/V from encoder states."""
    Bt, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = B.matmul(x, p["wq"]).reshape(Bt, S, KV, H // KV, dh)
    k, v = _cross_kv(p, enc, cfg)
    out = B._sdpa_chunk(q, k, v, None, None, None, causal=False)
    return B.matmul(out.reshape(Bt, S, H * dh), p["wo"])


def _cross_decode(p, x, enc, valid, cfg: ArchConfig):
    """One token's cross attention (x (B, 1, D)) through K6, every frame
    valid; the output in q's type, as ``blocks.attn_decode``'s."""
    Bt = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = B.matmul(x, p["wq"]).reshape(Bt, KV, H // KV, dh)
    with device_range("whisper.cross_kv"):
        k, v = _cross_kv(p, enc, cfg)
    out = flash_decode(q, k, v, valid)
    return B.matmul(out.reshape(Bt, 1, H * dh), p["wo"])


def _dec_block(pl, h, pos, enc, cfg: ArchConfig):
    """One decoder layer on h (B, S, D) -> (h, (k, v) of its
    self-attention)."""
    eps = cfg.norm_eps
    a, kv = B.attn_apply(pl["self_attn"], B.rmsnorm(h, pl["ln1"], eps), cfg,
                         pos)
    h = h + a
    h = h + _cross_attend(pl["cross_attn"], B.rmsnorm(h, pl["ln_x"], eps),
                          enc, cfg)
    h = h + B.mlp_apply(pl["mlp"], B.rmsnorm(h, pl["ln2"], eps))
    return h, kv


def _decode_stack(params, cfg: ArchConfig, h, pos, enc):
    for pl in _unbind(params["dec"], cfg.n_layers):
        h, _ = _dec_block(pl, h, pos, enc, cfg)
    return B.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def loss_train(params, cfg: ArchConfig, batch, aux_weight: float = 0.0):
    """batch: frames (B, F, D), tokens (B, S), labels (B, S) -> the mean
    cross entropy (an f32 scalar that autograd differentiates), the vocab
    projection chunked over ``lm.LOSS_CHUNK`` positions.  There is no aux
    loss: ``aux_weight`` is taken for the uniform interface."""
    enc = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    Bt, S = tokens.shape
    h = params["embed"][tokens.long()]
    h = _decode_stack(params, cfg, h, _arange_pos(Bt, S, h.device), enc)
    return _ce_total(h, params["embed"].T, batch["labels"]) / (Bt * S)


# ---------------------------------------------------------------------------
# caches / prefill / decode
# ---------------------------------------------------------------------------
def init_caches(cfg: ArchConfig, batch: int, length: int,
                dtype=torch.bfloat16, device="cuda"):
    """Self-attention KV caches stacked over decoder layers (leaves
    ``(n_layers, batch, ...)``) and the encoder states ``(batch,
    min(max_source_positions, length), D)``, in ``dtype``, on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return {"self": B.make_cache(cfg, batch, length, dtype=dtype, device=dev,
                                 lead=(cfg.n_layers,)),
            "enc": torch.zeros(batch, min(cfg.max_source_positions, length),
                               cfg.d_model, dtype=dtype, device=dev)}


def prefill(params, cfg: ArchConfig, batch, cache_len: Optional[int] = None,
            cache_dtype=torch.bfloat16):
    """Encode the frames and run the decoder over the prompt -> (last-token
    logits (B, vocab), caches): the self-attention caches of ``cache_len``
    positions and the encoder states, all frames, in ``cache_dtype``."""
    enc = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    Bt, S = tokens.shape
    C = cache_len or S
    pos = _arange_pos(Bt, S, tokens.device)
    h = params["embed"][tokens.long()]
    cache = B.make_cache(cfg, Bt, C, dtype=cache_dtype, device=h.device,
                         lead=(cfg.n_layers,))
    n = min(S, C)           # the last C entries, or the S entries padded
    for j in range(cfg.n_layers):
        h, (k, v) = _dec_block(_layer(params["dec"], j), h, pos, enc, cfg)
        cache["k"][j, :, :n] = k[:, S - n:].to(cache_dtype)
        cache["v"][j, :, :n] = v[:, S - n:].to(cache_dtype)
        cache["pos"][j, :, :n] = pos[:, S - n:]
        cache["idx"][j] = S
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = B.matmul(h[:, -1], params["embed"].T)
    return logits, {"self": cache, "enc": enc.to(cache_dtype)}


def decode_step(params, cfg: ArchConfig, token, caches, pos):
    """token: (B, 1) int; pos: (B, 1) int.  Returns (logits (B, vocab),
    caches), the self-attention caches updated in place."""
    h = params["embed"][token.long()]
    enc = caches["enc"]
    valid = torch.ones(enc.shape[:2], dtype=torch.bool, device=enc.device)
    eps = cfg.norm_eps
    for j in range(cfg.n_layers):
        pl = _layer(params["dec"], j)
        a, _ = B.attn_decode(pl["self_attn"], B.rmsnorm(h, pl["ln1"], eps),
                             cfg, pos, _layer(caches["self"], j))
        h = h + a
        h = h + _cross_decode(pl["cross_attn"],
                              B.rmsnorm(h, pl["ln_x"], eps), enc, valid, cfg)
        h = h + B.mlp_apply(pl["mlp"], B.rmsnorm(h, pl["ln2"], eps))
    h = B.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return B.matmul(h[:, 0], params["embed"].T), caches
