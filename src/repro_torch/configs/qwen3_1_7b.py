"""qwen3-1.7b [dense] — qk_norm, GQA  [hf:Qwen/Qwen3-8B family]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense", citation="hf:Qwen/Qwen3-8B",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144, vocab=151936,
    d_head=128, pattern=("attn",), qk_norm=True, rope_theta=1e6)

SMOKE = ArchConfig(
    name="qwen3-smoke", family="dense", citation="hf:Qwen/Qwen3-8B",
    n_layers=2, d_model=256, n_heads=4, n_kv=2, d_ff=512, vocab=512,
    d_head=64, pattern=("attn",), qk_norm=True, rope_theta=1e6)
