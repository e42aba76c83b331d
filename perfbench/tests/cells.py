"""The benchmark's cells at sizes a CPU test can hold: the committed
configuration, traffic and job files, every width, depth and batch cut."""
from __future__ import annotations

import copy

from perfbench import manifest

LM = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
      "num_key_value_heads": 2, "head_dim": 8, "intermediate_size": 64,
      "vocab_size": 128}
LM_ARCH = {"d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv": 2,
           "d_head": 8, "d_ff": 64, "vocab": 128}
WHISPER = {"d_model": 32, "encoder_layers": 2, "decoder_layers": 2,
           "encoder_attention_heads": 2, "decoder_attention_heads": 2,
           "encoder_ffn_dim": 64, "decoder_ffn_dim": 64, "vocab_size": 128}
WHISPER_ARCH = {"d_model": 32, "n_layers": 2, "enc_layers": 2, "n_heads": 2,
                "n_kv": 2, "d_head": 16, "d_ff": 64, "vocab": 128}
JOBS = {"lm": {"batch": 4, "seq": 8, "reference_rows": 1},
        "whisper": {"fl": 3, "Kn": [2, 2, 2], "batch": 2, "seq": 8,
                    "frames": 12, "reference_rows": 1}}
CELLS = ("qwen3-1.7b.fed-int8", "whisper-tiny-style.fed-int8")


def small(cell_name: str) -> dict:
    """Cell ``cell_name`` at test sizes."""
    spec = copy.deepcopy(manifest.cell(manifest.load(), cell_name))
    cfg = spec["config"]
    kind = cfg["reference"]
    cfg.update(LM if kind == "lm" else WHISPER)
    cfg["arch"].update(LM_ARCH if kind == "lm" else WHISPER_ARCH)
    spec["job"].update(JOBS[kind])
    return spec
