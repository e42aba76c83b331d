"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, xLSTM[7:1] ratio
[arXiv:2405.04517]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm", citation="arXiv:2405.04517",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    d_head=512, pattern=("mlstm",) * 7 + ("slstm",))

SMOKE = ArchConfig(
    name="xlstm-smoke", family="ssm", citation="arXiv:2405.04517",
    n_layers=2, d_model=256, n_heads=4, n_kv=4, d_ff=0, vocab=512,
    d_head=64, pattern=("mlstm", "slstm"))
