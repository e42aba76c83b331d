"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense", citation="arXiv:2407.21783",
    n_layers=126, d_model=16384, n_heads=128, n_kv=8, d_ff=53248,
    vocab=128256, d_head=128, pattern=("attn",), rope_theta=5e5)

SMOKE = ArchConfig(
    name="llama3-smoke", family="dense", citation="arXiv:2407.21783",
    n_layers=2, d_model=512, n_heads=8, n_kv=2, d_ff=1024, vocab=512,
    d_head=64, pattern=("attn",), rope_theta=5e5)
