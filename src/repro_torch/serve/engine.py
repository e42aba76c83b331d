"""Batched serving engine (``repro/serve/engine.py``): slot-based
continuous batching over the LM decode step, in PyTorch.

A fixed pool of ``slots`` shares one KV cache; requests join free slots,
prefill as a batch-of-one (cache splice), then decode together, the decode
attention through flash decode (K6) on the card.  Greedy sampling;
completion on EOS or max_new_tokens.  The engine runs on the card unless
the caller passes ``device="cpu"``; the params must lie on that device.
It serves the dense, MoE, hybrid, xLSTM, VLM and audio families: a mamba2
layer's slot holds its SSM state ``{"h", "conv"}``, an xLSTM layer's its
f32 state, leaves spliced like a KV cache.  The
prefilled conv tail is rounded to the cache's type on admission, as the
reference's splice casts it into its cache leaf; the reference's decode
step then promotes that leaf to f32, which the port's leaf is from the
start.  (The reference rounds only the tails it splices before its first
step, the port every admission's: one rounding of ``ssm_conv - 1`` rows,
gone from the conv window ``ssm_conv - 1`` steps later.)  Under MoE every
slot's token, an idle slot's too, takes expert capacity in token order, so
a slot's tokens depend on the others, as in the reference.  A hybrid
prompt shorter than ``ssm_conv - 1`` tokens raises :class:`ValueError` at
admission.  A VLM request (qwen2-vl) is admitted as the reference admits
it: zero patch embeddings over the first ``max(1, int(P *
vision_patches_frac))`` positions and three equal M-RoPE streams
``arange(P)``.  An encoder-decoder request (whisper) is admitted with zero
frames ``(1, max_source_positions, d_model)`` f32, as the reference's; its
caches are ``{"self": KV caches (n_layers, slots, ...), "enc": encoder
states (slots, frames, D)}``.  Such an engine needs ``max_len >=
max_source_positions``: the encoder cache holds ``min(frames, max_len)``
rows and prefill returns every frame, so a shorter one raises
:class:`ValueError` at construction (the reference fails at its first
admission).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..models.registry import model_api

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (P,) int32 token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine
    output: Optional[List[int]] = None
    slot: int = -1
    done: bool = False
    failed: bool = False               # rejected at admission (no slot used)
    error: Optional[str] = None


class ServeEngine:
    def __init__(self, params, cfg: ArchConfig, slots: int = 4,
                 max_len: int = 256, cache_dtype=torch.bfloat16,
                 device="cuda"):
        if cfg.encdec and max_len < cfg.max_source_positions:
            raise ValueError(
                f"an encoder-decoder engine needs max_len ({max_len}) >= "
                f"max_source_positions ({cfg.max_source_positions}): its "
                f"encoder cache holds min(frames, max_len) rows")
        self.params = params
        self.cfg = cfg
        self.api = model_api(cfg)
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.caches = self.api.init_caches(cfg, slots, max_len,
                                           dtype=cache_dtype,
                                           device=self.device)
        self.pos = np.zeros(slots, np.int32)        # next position per slot
        self.active: List[Optional[Request]] = [None] * slots
        self.last_tok = np.zeros((slots, 1), np.int32)
        #: prefills and decode steps done, and the host seconds they took;
        #: each interval ends when the greedy tokens reach the host, which
        #: waits for the device
        self.stats = {"prefills": 0, "prefill_s": 0.0, "decode_steps": 0,
                      "decode_s": 0.0}

    # ------------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _splice_cache(self, slot: int, new_caches):
        """Copy a freshly prefilled batch-of-one cache into slot ``slot``
        (every leaf, KV cache or SSM state, is (count, B, ...), the batch
        on axis 1; whisper's encoder states (B, frames, D) have it on axis
        0), cast to the leaf's type; an SSM conv tail rounded through the
        cache's type first."""
        if self.cfg.encdec:
            self.caches["enc"][slot:slot + 1].copy_(new_caches["enc"])
            pairs = [(self.caches["self"], new_caches["self"])]
        else:
            pairs = zip(self.caches, new_caches)
        for full, one in pairs:
            for key, leaf in full.items():
                src = one[key]
                if key == "conv":
                    src = src.to(self.cache_dtype)
                leaf[:, slot:slot + 1].copy_(src)

    @torch.no_grad()
    def submit(self, req: Request) -> bool:
        """Admit a request if a slot is free.  Prefills immediately.

        Returns True when the request was *consumed* — admitted to a slot,
        or rejected (``req.failed`` set) because it can never fit the KV
        cache; a rejection occupies no slot and the engine keeps serving.
        False means "no free slot, try again later"."""
        P = len(req.prompt)
        if P + req.max_new_tokens > self.max_len:
            req.done = True
            req.failed = True
            req.output = []
            req.error = (f"prompt ({P}) + max_new_tokens "
                         f"({req.max_new_tokens}) exceeds the engine's "
                         f"max_len ({self.max_len})")
            return True
        slot = self._free_slot()
        if slot is None:
            return False
        t0 = time.perf_counter()
        batch = {"tokens": torch.as_tensor(np.asarray(req.prompt, np.int64),
                                           device=self.device)[None]}
        if self.cfg.family == "vlm":
            npatch = max(1, int(P * self.cfg.vision_patches_frac))
            batch["patch_embeds"] = torch.zeros(1, npatch, self.cfg.d_model,
                                                device=self.device)
            pos = torch.arange(P, device=self.device)[None]
            batch["positions3"] = torch.stack([pos, pos, pos])
        if self.cfg.encdec:
            batch["frames"] = torch.zeros(1, self.cfg.max_source_positions,
                                          self.cfg.d_model,
                                          device=self.device)
        logits, one_caches = self.api.prefill(self.params, self.cfg, batch,
                                              cache_len=self.max_len,
                                              cache_dtype=self.cache_dtype)
        self._splice_cache(slot, one_caches)
        req.slot = slot
        req.output = [int(torch.argmax(logits[0]))]
        self.stats["prefills"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.pos[slot] = P
        self.last_tok[slot, 0] = req.output[-1]
        self.active[slot] = req
        return True

    @torch.no_grad()
    def step(self) -> int:
        """One decode step for every slot (idle ones too, as the reference
        does).  Returns #active."""
        if not any(r is not None for r in self.active):
            return 0
        t0 = time.perf_counter()
        toks = torch.as_tensor(self.last_tok, device=self.device)
        pos = torch.as_tensor(self.pos[:, None], device=self.device)
        logits, self.caches = self.api.decode_step(self.params, self.cfg,
                                                   toks, self.caches, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        n_active = 0
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.output.append(int(nxt[i]))
            self.pos[i] += 1
            self.last_tok[i, 0] = nxt[i]
            if (len(r.output) >= r.max_new_tokens
                    or (r.eos_id is not None and nxt[i] == r.eos_id)):
                r.done = True
                self.active[i] = None
            else:
                n_active += 1
        return n_active

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests to completion (simple FCFS queue)."""
        queue = list(requests)
        while queue or any(r is not None for r in self.active):
            while queue and self.submit(queue[0]):
                queue.pop(0)
            self.step()
        return requests
