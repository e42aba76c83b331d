"""whisper-tiny [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].
n_layers counts decoder layers; the encoder has enc_layers more."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio", citation="arXiv:2212.04356",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
    d_head=64, encdec=True, enc_layers=4, max_source_positions=1500)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio", citation="arXiv:2212.04356",
    n_layers=2, d_model=128, n_heads=2, n_kv=2, d_ff=256, vocab=512,
    d_head=64, encdec=True, enc_layers=2, max_source_positions=64)
