"""Architecture + run configuration schema, copied from the JAX package's
``repro/configs/base.py`` (which imports no JAX; the port keeps its own
copy).

Every ported architecture gets one ``<id>.py`` in this package exporting
``CONFIG`` (the exact published shape) and ``SMOKE`` (a reduced variant of
the same family).  ``MeshLayout`` is the (fl, fsdp, tp) mesh fold of the
JAX package's launcher; the port's runtime reads only its fl axis
(:mod:`repro_torch.fed`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "MeshLayout"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    citation: str                    # source model card / paper
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # --- layer pattern: cycled to n_layers, then segmented into runs --------
    # block ids: attn | attn_moe | local | global | mamba2 | shared_attn |
    #            mlstm | slstm
    pattern: Tuple[str, ...] = ("attn",)
    # --- attention options ---------------------------------------------------
    qk_norm: bool = False
    window: Optional[int] = None     # sliding-window size for "local" blocks
    rope_theta: float = 1e4
    mrope: bool = False              # M-RoPE (3D positions), qwen2-vl
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t/h/w split of d_head/2
    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # expert hidden size (olmoe: 1024)
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # --- enc-dec (whisper) ------------------------------------------------------
    encdec: bool = False
    enc_layers: int = 0
    max_source_positions: int = 1500  # whisper frame cap (30 s audio)
    # --- vlm stub -----------------------------------------------------------------
    vision_patches_frac: float = 0.25  # fraction of seq filled by patch embeds
    # --- misc ---------------------------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # --- derived ------------------------------------------------------------
    @property
    def layer_types(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    @property
    def segments(self) -> Tuple[Tuple[str, int], ...]:
        """Maximal runs of equal block type — each becomes one scan."""
        segs = []
        for t in self.layer_types:
            if segs and segs[-1][0] == t:
                segs[-1][1] += 1
            else:
                segs.append([t, 1])
        return tuple((t, c) for t, c in segs)

    @property
    def attention_free(self) -> bool:
        return all(t in ("mamba2", "mlstm", "slstm") for t in self.layer_types)

    @property
    def full_attention_only(self) -> bool:
        """True if every attention block is unwindowed full attention."""
        return any(t in ("attn", "attn_moe", "global", "shared_attn")
                   for t in self.layer_types) and self.window is None

    def supports_long_context(self) -> bool:
        """Eligible for long_500k: sub-quadratic per-token decode state growth
        bounded by windows/recurrence, or explicitly windowed + sparse-global.
        """
        if self.encdec:
            return False
        if self.attention_free:
            return True
        # hybrid / windowed archs with only sparse global layers qualify
        types = set(self.layer_types)
        if "mamba2" in types or "mlstm" in types:
            return True
        return self.window is not None and "local" in types

    # --- parameter counting (for MODEL_FLOPS and reporting) -------------------
    def param_count(self, active_only: bool = False) -> int:
        D, H, KV, dh, F, V = (self.d_model, self.n_heads, self.n_kv,
                              self.d_head, self.d_ff, self.vocab)
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D
        for t in self.layer_types:
            if t in ("attn", "local", "global", "shared_attn", "attn_moe"):
                attn = D * H * dh + 2 * D * KV * dh + H * dh * D
                total += attn + 2 * D
                if t == "attn_moe":
                    e = self.top_k if active_only else self.n_experts
                    total += self.n_experts * D  # router always resident
                    total += e * 3 * D * self.d_expert
                else:
                    total += 3 * D * F
            elif t == "mamba2":
                di = self.ssm_expand * D
                nh = di // self.ssm_head_dim
                total += D * (2 * di + 2 * self.ssm_state + nh) + di * D
                total += 2 * D
            elif t in ("mlstm", "slstm"):
                di = 2 * D if t == "mlstm" else D
                total += D * 2 * di + 3 * di * (di // max(self.n_heads, 1)) \
                    + di * D + 2 * D
        return int(total)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """How the physical mesh folds into logical (fl, fsdp, tp) axes.

    fl   — federated-worker axis (GenQSGD replica groups; pods fold in here)
    fsdp — parameter/batch sharding inside one worker
    tp   — tensor parallel
    """
    fl_sub: int = 1     # how many FL workers per pod (divides the data axis)
    tp: int = 16

    def logical_shape(self, pods: int, data: int, model: int):
        assert data % self.fl_sub == 0
        assert model == self.tp
        return (pods * self.fl_sub, data // self.fl_sub, model)
