"""mistral-large-123b [dense] — GQA  [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_ff=28672, vocab=32768,
    d_head=128, pattern=("attn",), rope_theta=1e6)

SMOKE = ArchConfig(
    name="mistral-large-smoke", family="dense",
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=2, d_model=384, n_heads=6, n_kv=2, d_ff=768, vocab=512,
    d_head=64, pattern=("attn",), rope_theta=1e6)
