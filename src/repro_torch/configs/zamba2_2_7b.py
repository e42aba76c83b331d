"""zamba2-2.7b [hybrid] — Mamba2 blocks + one weight-shared attention block
applied every 6th layer, ssm_state=64 [arXiv:2411.15242]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", citation="arXiv:2411.15242",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240, vocab=32000,
    d_head=80, pattern=("mamba2",) * 5 + ("shared_attn",),
    ssm_state=64, ssm_expand=2, ssm_head_dim=64)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid", citation="arXiv:2411.15242",
    n_layers=3, d_model=256, n_heads=4, n_kv=4, d_ff=512, vocab=512,
    d_head=64, pattern=("mamba2", "mamba2", "shared_attn"),
    ssm_state=16, ssm_expand=2, ssm_head_dim=64)
