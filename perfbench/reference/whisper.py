"""Plain reference of the encoder-decoder that the benchmark's ``whisper``
configurations name, as the port's package models it (arXiv:2212.04356's
layer counts and widths; the blocks of the port's ``models/whisper.py``):
the input is the convolution front end's output, frames (B, F, D); the
encoder is bidirectional self-attention with RoPE on the frame index and
a gated SiLU MLP; each decoder layer is causal self-attention (RoPE),
cross-attention over the encoder's states (no RoPE) and the MLP; RMSNorm
everywhere, no biases, tied embeddings.  Where the published model uses
LayerNorm, GELU MLPs and absolute positions, the configuration file lists
the departure.

Configuration keys are the published ``config.json``'s (``d_model``,
``encoder_layers``, ...), plus ``rms_norm_eps`` and ``rope_theta``."""
from __future__ import annotations

from . import ops
from .tree import Leaf


def _dims(cfg: dict):
    D, H = cfg["d_model"], cfg["decoder_attention_heads"]
    if cfg["encoder_attention_heads"] != H \
            or cfg["encoder_ffn_dim"] != cfg["decoder_ffn_dim"]:
        raise ValueError("the reference takes one head count and one MLP "
                         "width for the encoder and the decoder")
    return D, H, D // H, cfg["decoder_ffn_dim"], cfg["vocab_size"]


def param_spec(cfg: dict) -> dict:
    D, H, dh, Fd, V = _dims(cfg)
    E, L = cfg["encoder_layers"], cfg["decoder_layers"]

    def proj(n, d_in, d_out):
        return Leaf((n, d_in, d_out), d_in ** -0.5)

    def attn(n):
        return {"wq": proj(n, D, H * dh), "wk": proj(n, D, H * dh),
                "wv": proj(n, D, H * dh), "wo": proj(n, H * dh, D)}

    def mlp(n):
        return {"w_gate": proj(n, D, Fd), "w_up": proj(n, D, Fd),
                "w_down": proj(n, Fd, D)}

    def norm(*lead):
        return Leaf((*lead, D), None)
    return {"embed": Leaf((V, D), D ** -0.5),
            "enc": {"ln1": norm(E), "attn": attn(E), "ln2": norm(E),
                    "mlp": mlp(E)},
            "enc_norm": norm(),
            "dec": {"ln1": norm(L), "self_attn": attn(L), "ln_x": norm(L),
                    "cross_attn": attn(L), "ln2": norm(L), "mlp": mlp(L)},
            "final_norm": norm()}


def train_flops(cfg: dict, job: dict) -> float:
    """Model FLOPs of one local step at the job's batch (B utterances of
    F frames and S text tokens): the matrix products of the encoder over
    the frames, of the decoder over the tokens, the cross-attention's K and
    V over the frames, the tied output head, and attention's score and
    value products (every frame pair in the encoder, the causal pairs in
    the decoder, every token-frame pair across), times 3 for the forward
    and the backward; nothing recomputed."""
    D, H, dh, Fd, V = _dims(cfg)
    E, L = cfg["encoder_layers"], cfg["decoder_layers"]
    B, F, S = job["batch"], job["frames"], job["seq"]
    attn_proj, mlp = 4 * D * H * dh, 3 * D * Fd
    enc = E * (F * 2 * (attn_proj + mlp) + 4 * H * dh * F * F)
    dec = L * (S * 2 * (attn_proj + 2 * D * H * dh + mlp)
               + F * 2 * 2 * D * H * dh
               + 4 * H * dh * (S * (S + 1) // 2 + S * F))
    return 3.0 * B * (enc + dec + S * 2 * D * V)


def _layer(tree: dict, j: int) -> dict:
    return {k: _layer(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def _self_attn(a, x, H, dh, theta, causal):
    B, S, _ = x.shape
    q = (x @ a["wq"]).reshape(B, S, H, dh)
    k = (x @ a["wk"]).reshape(B, S, H, dh)
    v = (x @ a["wv"]).reshape(B, S, H, dh)
    return ops.attention(ops.rope(q, theta), ops.rope(k, theta), v,
                         causal) @ a["wo"]


def loss(p: dict, cfg: dict, batch: dict):
    """Mean next-token cross entropy of ``batch`` (frames (B, F, D),
    tokens and labels (B, S)) under params ``p`` (in the compute type)."""
    D, H, dh, _, _ = _dims(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = batch["frames"]
    for j in range(cfg["encoder_layers"]):
        pl = _layer(p["enc"], j)
        h = h + _self_attn(pl["attn"], ops.rmsnorm(h, pl["ln1"], eps), H, dh,
                           theta, causal=False)
        h = h + ops.gated_mlp(pl["mlp"], ops.rmsnorm(h, pl["ln2"], eps))
    enc = ops.rmsnorm(h, p["enc_norm"], eps)
    B, F = enc.shape[:2]
    tokens = batch["tokens"].long()
    S = tokens.shape[1]
    h = p["embed"][tokens]
    for j in range(cfg["decoder_layers"]):
        pl = _layer(p["dec"], j)
        h = h + _self_attn(pl["self_attn"], ops.rmsnorm(h, pl["ln1"], eps),
                           H, dh, theta, causal=True)
        c = pl["cross_attn"]
        q = (ops.rmsnorm(h, pl["ln_x"], eps) @ c["wq"]).reshape(B, S, H, dh)
        k = (enc @ c["wk"]).reshape(B, F, H, dh)
        v = (enc @ c["wv"]).reshape(B, F, H, dh)
        h = h + ops.attention(q, k, v, causal=False) @ c["wo"]
        h = h + ops.gated_mlp(pl["mlp"], ops.rmsnorm(h, pl["ln2"], eps))
    h = ops.rmsnorm(h, p["final_norm"], eps)
    return ops.mean_ce(h, p["embed"].T, batch["labels"])
