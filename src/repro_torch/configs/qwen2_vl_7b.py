"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (ViT frontend STUB)
[arXiv:2409.12191]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm", citation="arXiv:2409.12191",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, d_ff=18944, vocab=152064,
    d_head=128, pattern=("attn",), mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6, vision_patches_frac=0.25)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke", family="vlm", citation="arXiv:2409.12191",
    n_layers=2, d_model=256, n_heads=4, n_kv=2, d_ff=512, vocab=512,
    d_head=64, pattern=("attn",), mrope=True, mrope_sections=(8, 12, 12),
    rope_theta=1e6, vision_patches_frac=0.25)
