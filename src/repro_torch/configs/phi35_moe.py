"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400, vocab=32064,
    d_head=128, pattern=("attn_moe",), n_experts=16, top_k=2, d_expert=6400,
    rope_theta=1e4, capacity_factor=1.0)

SMOKE = ArchConfig(
    name="phi35-moe-smoke", family="moe",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=2, d_model=256, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    d_head=64, pattern=("attn_moe",), n_experts=4, top_k=2, d_expert=256,
    rope_theta=1e4)
