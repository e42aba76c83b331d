"""gemma3-4b [dense] — 5:1 local:global sliding-window, 128k context
[hf:google/gemma-3-1b-pt family].  Single rope_theta (1e6) is used for both
local and global layers (the HF card uses 10k local / 1M global)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense", citation="hf:google/gemma-3-1b-pt",
    n_layers=34, d_model=2560, n_heads=8, n_kv=4, d_ff=10240, vocab=262144,
    d_head=256, pattern=("local",) * 5 + ("global",), window=1024,
    qk_norm=True, rope_theta=1e6)

SMOKE = ArchConfig(
    name="gemma3-smoke", family="dense", citation="hf:google/gemma-3-1b-pt",
    n_layers=3, d_model=256, n_heads=4, n_kv=2, d_ff=512, vocab=512,
    d_head=64, pattern=("local", "local", "global"), window=64,
    qk_norm=True, rope_theta=1e6)
