"""olmoe-1b-7b [moe] — 64 experts top-8, d_expert=1024 [arXiv:2409.02060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe", citation="arXiv:2409.02060",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024, vocab=50304,
    d_head=128, pattern=("attn_moe",), n_experts=64, top_k=8, d_expert=1024,
    rope_theta=1e4)

SMOKE = ArchConfig(
    name="olmoe-smoke", family="moe", citation="arXiv:2409.02060",
    n_layers=2, d_model=256, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    d_head=64, pattern=("attn_moe",), n_experts=4, top_k=2, d_expert=128,
    rope_theta=1e4)
