"""Plain reference of a dense decoder-only LM (Qwen3: grouped-query
attention with RMS-normed queries and keys, rotate-half RoPE, a gated SiLU
MLP, pre-norm residual blocks, tied input and output embeddings), its
parameter tree and its training loss.

Configuration keys are the published ``config.json``'s (``hidden_size``,
``num_hidden_layers``, ...), plus ``qk_norm``.  The parameter tree is the
layout the benchmark hands the program: the layers' leaves stacked on a
leading axis under ``segments[0]``; projections N(0, 1/d_in), the
embedding N(0, 1/D), norms ones."""
from __future__ import annotations

from . import ops
from .tree import Leaf


def param_spec(cfg: dict) -> dict:
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    Fd, V = cfg["intermediate_size"], cfg["vocab_size"]
    if not cfg["tie_word_embeddings"]:
        raise ValueError("the reference ties the input and output "
                         "embeddings, as the configuration's source does")

    def proj(d_in, d_out):
        return Leaf((L, d_in, d_out), d_in ** -0.5)
    attn = {"wq": proj(D, H * dh), "wk": proj(D, KV * dh),
            "wv": proj(D, KV * dh), "wo": proj(H * dh, D)}
    if cfg["qk_norm"]:
        attn["q_norm"] = Leaf((L, dh), None)
        attn["k_norm"] = Leaf((L, dh), None)
    layer = {"ln1": Leaf((L, D), None), "ln2": Leaf((L, D), None),
             "attn": attn,
             "mlp": {"w_gate": proj(D, Fd), "w_up": proj(D, Fd),
                     "w_down": proj(Fd, D)}}
    return {"embed": Leaf((V, D), D ** -0.5),
            "final_norm": Leaf((D,), None), "segments": [layer]}


def train_flops(cfg: dict, job: dict) -> float:
    """Model FLOPs of one local step at the job's batch: the forward's
    matrix products (projections, MLP, the tied output head) and
    attention's score and value products over the causal pairs, times 3
    for the forward and the backward; nothing recomputed."""
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    B, S = job["batch"], job["seq"]
    per_token = 2 * (L * (2 * D * H * dh + 2 * D * KV * dh
                          + 3 * D * cfg["intermediate_size"])
                     + D * cfg["vocab_size"])
    attn = L * B * 4 * H * dh * S * (S + 1) // 2
    return 3.0 * (B * S * per_token + attn)


def loss(p: dict, cfg: dict, batch: dict):
    """Mean next-token cross entropy of ``batch`` (tokens, labels (B, S))
    under params ``p`` (already in the compute type)."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    h = p["embed"][tokens]
    seg = p["segments"][0]
    for j in range(cfg["num_hidden_layers"]):
        a = {k: v[j] for k, v in seg["attn"].items()}
        x = ops.rmsnorm(h, seg["ln1"][j], eps)
        q = (x @ a["wq"]).reshape(B, S, H, dh)
        k = (x @ a["wk"]).reshape(B, S, KV, dh)
        v = (x @ a["wv"]).reshape(B, S, KV, dh)
        if cfg["qk_norm"]:
            q = ops.rmsnorm(q, a["q_norm"], eps)
            k = ops.rmsnorm(k, a["k_norm"], eps)
        o = ops.attention(ops.rope(q, theta), ops.rope(k, theta), v,
                          causal=True)
        h = h + o @ a["wo"]
        x = ops.rmsnorm(h, seg["ln2"][j], eps)
        h = h + ops.gated_mlp({k: v[j] for k, v in seg["mlp"].items()}, x)
    h = ops.rmsnorm(h, p["final_norm"], eps)
    return ops.mean_ce(h, p["embed"].T, batch["labels"])
