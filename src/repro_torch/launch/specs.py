"""Abstract input construction for every (arch × input-shape) case
(``repro/launch/specs.py``), on fake tensors.

``build_case`` returns the step function and its example arguments as
``FakeTensor``s made under one ``FakeTensorMode`` (``Case.mode``): shapes
and dtypes with nothing allocated, so llama3-405b's 1.6 TB of f32 weights
cost nothing.  Run ``case.fn(*case.args)`` inside ``with case.mode:`` to get
its outputs' shapes, or under ``torch.utils.flop_counter.FlopCounterMode``
its FLOPs (:mod:`repro_torch.launch.dryrun`, :mod:`repro_torch.launch.
roofline`).

Shape kinds:
  train   -> the GenQSGD round (``fed/runtime.py::make_round_fn``: fl
             workers' local steps, then the quantized aggregation)
  prefill -> full-sequence forward, returns last-token logits + caches
  decode  -> ONE token against a seq_len-deep cache

``repro``'s ``MOE_TP_ONLY``, serving tp, ``_act_sharding`` and
``Case.activation_ctx`` have no counterpart: they lay a case out over a
pod's GSPMD mesh, and one card runs a case whole (``repro_torch/fed/
__init__.py``).  ``FL_SUB`` is the training plan's fl worker count, which
here is the transport's worker count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import INPUT_SHAPES, ArchConfig, InputShape
from ..fed.runtime import FedConfig, make_round_fn
from ..models.registry import get_config, model_api

__all__ = ["build_case", "Case", "FL_SUB", "MICROBATCH", "PARAM_DTYPE",
           "case_supported", "tree_bytes"]

# the training plan's fl workers per arch (``repro``'s MESH_PLAN fl_sub);
# giants keep one: their GenQSGD axis is the pod axis itself
FL_SUB = {
    "qwen3-1.7b": 4,
    "mistral-large-123b": 1,
    "gemma3-4b": 4,
    "qwen2-vl-7b": 2,
    "olmoe-1b-7b": 4,
    "llama3-405b": 1,
    "xlstm-1.3b": 4,
    "zamba2-2.7b": 4,
    "whisper-tiny": 8,
    "phi3.5-moe-42b-a6.6b": 2,
}

# grad-accumulation microbatches per local step (activation memory / M)
MICROBATCH = {
    "llama3-405b": 8,
    "mistral-large-123b": 4,
    "phi3.5-moe-42b-a6.6b": 2,
    "qwen2-vl-7b": 2,
}

# param dtype for the *dry-run* master copy (f32 unless memory-bound)
PARAM_DTYPE = {
    "llama3-405b": torch.bfloat16,
    "mistral-large-123b": torch.bfloat16,
    "phi3.5-moe-42b-a6.6b": torch.bfloat16,
}


def case_supported(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """None if supported, else a human-readable skip reason."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        if cfg.encdec:
            return ("enc-dec audio family: 512k decoder context is not "
                    "meaningful (30 s audio, <=448 target positions)")
        return ("pure full-attention arch: 512k decode skipped per brief "
                "(no sliding-window/recurrent variant)")
    return None


def _abstract_batch(cfg: ArchConfig, shape: InputShape, lead=(),
                    mode=None) -> dict:
    """Token batch fake tensors with the given leading dims, made under
    ``mode`` (a ``FakeTensorMode``; a fresh one by default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    B = shape.global_batch
    S = shape.seq_len
    if lead:  # training: (fl, K) leading; per-worker batch slice
        B = B // lead[0]
    with mode if mode is not None else FakeTensorMode():
        batch = {
            "tokens": torch.empty(lead + (B, S), dtype=torch.int32),
            "labels": torch.empty(lead + (B, S), dtype=torch.int32),
        }
        if cfg.family == "vlm":
            npatch = int(S * cfg.vision_patches_frac)
            batch["patch_embeds"] = torch.empty(
                lead + (B, npatch, cfg.d_model), dtype=torch.bfloat16)
            batch["positions3"] = torch.empty(lead + (3, B, S),
                                              dtype=torch.int32)
        if cfg.encdec:
            F = min(cfg.max_source_positions, S)
            batch["frames"] = torch.empty(lead + (B, F, cfg.d_model),
                                          dtype=torch.bfloat16)
    return batch


def _leaves(tree) -> list:
    """Every tensor and NumPy array in a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, (torch.Tensor, np.ndarray)) else []


def _tensors(tree) -> list:
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of every tensor and NumPy array (the host's key words) in
    ``tree``."""
    return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
               else t.nbytes for t in _leaves(tree))


@dataclasses.dataclass
class Case:
    arch: str
    shape: InputShape
    cfg: ArchConfig
    fn: Any               # the step function, run under ``mode``
    args: tuple           # fake example args
    fed: Optional[FedConfig] = None
    mode: Any = None      # the FakeTensorMode that made ``args``

    def argument_bytes(self) -> int:
        return tree_bytes(self.args)

    def count(self, whole_round: bool = False) -> dict:
        """FLOPs and new output bytes of the step on the fake tensors ->
        ``{"flops", "output_bytes", "counted"}``.  FLOPs are those of every
        matmul, convolution and attention product (``FlopCounterMode``;
        elementwise work is not counted); output bytes those of the outputs
        the step allocates (an output that is an argument updated in place,
        as decode's caches, is not counted again).

        A prefill or decode step runs whole.  A training round's fl workers
        each run K_max local steps of ``microbatch`` passes (virtual steps
        included), all alike in shape, and its aggregate has no product to
        count: so by default one local step of worker 0 runs (``counted:
        "local step"``, its FLOPs times fl·K_max) and the round's outputs
        (x̂', shaped as the params, and two f32 metrics) are priced by
        formula.  ``whole_round=True`` runs the round itself (``counted:
        "round"``), which takes fl·K_max times as long on fake tensors."""
        from torch.utils.flop_counter import FlopCounterMode
        fed = self.fed
        if fed is not None and not whole_round:
            from ..fed.runtime import local_train
            params, batch, _, _, gamma = self.args
            one = dataclasses.replace(fed, n_workers=1, Kn=(1,))
            step = {k: v[0, :1] for k, v in batch.items()}
            api = model_api(self.cfg)
            with self.mode, FlopCounterMode(display=False) as fc:
                local_train(api, self.cfg, one, params, step, 1, gamma)
            return {"flops": float(fc.get_total_flops())
                    * fed.n_workers * fed.K_max,
                    "output_bytes": tree_bytes(params) + 2 * 4,
                    "counted": "local step"}
        from torch.multiprocessing.reductions import StorageWeakRef
        with self.mode, FlopCounterMode(display=False) as fc:
            out = self.fn(*self.args)
        seen = {StorageWeakRef(t.untyped_storage())
                for t in _tensors(self.args)}
        new = 0
        for t in _tensors(out):
            ref = StorageWeakRef(t.untyped_storage())
            if ref not in seen:
                seen.add(ref)
                new += t.numel() * t.element_size()
        return {"flops": float(fc.get_total_flops()), "output_bytes": new,
                "counted": "round" if fed is not None else self.shape.kind}


def build_case(arch: str, shape_name: str, *, wire: str = "f32",
               k_local: int = 2, param_dtype=None, smoke: bool = False,
               cfg_override: Optional[ArchConfig] = None,
               microbatch: Optional[int] = None) -> Case:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg_override or get_config(arch, smoke=smoke)
    shape = INPUT_SHAPES[shape_name]
    reason = case_supported(cfg, shape)
    if reason:
        raise ValueError(f"{arch} x {shape_name} unsupported: {reason}")
    api = model_api(cfg)
    mode = FakeTensorMode()

    if shape.kind == "train":
        fl = FL_SUB.get(arch, 4)
        mb = microbatch if microbatch is not None else MICROBATCH.get(arch, 1)
        # heterogeneous per-worker K_n (alternating) when fl > 1 — the
        # paper's virtual-local-update masking (eqs. (6)-(8))
        kn = (tuple((k_local + (i % 2)) for i in range(fl)) if fl > 1
              else (k_local,) * fl)
        fed = FedConfig(n_workers=fl, Kn=kn, s0=64, sn=64,
                        wire=wire, microbatch=mb)
        pdtype = param_dtype or PARAM_DTYPE.get(arch, torch.float32)
        params = api.abstract_params(cfg, dtype=pdtype, mode=mode)
        batch = _abstract_batch(cfg, shape, lead=(fl, fed.K_max), mode=mode)
        args = (params, batch, np.zeros((fl, 2), np.uint32),
                np.zeros(2, np.uint32), np.float32(0.01))
        return Case(arch, shape, cfg, make_round_fn(api, cfg, fed), args,
                    fed=fed, mode=mode)

    params = api.abstract_params(cfg, dtype=torch.bfloat16, mode=mode)
    if shape.kind == "prefill":
        batch = _abstract_batch(cfg, shape, mode=mode)

        def prefill_fn(p, b):
            return api.prefill(p, cfg, b, cache_len=shape.seq_len)

        return Case(arch, shape, cfg, prefill_fn, (params, batch), mode=mode)

    # decode
    B = shape.global_batch
    with mode:
        caches = api.init_caches(cfg, B, shape.seq_len, dtype=torch.bfloat16,
                                 device="cpu")
        tok = torch.empty((B, 1), dtype=torch.int32)
        pos = torch.empty((B, 1), dtype=torch.int32)

    def serve_step(p, t, c, po):
        return api.decode_step(p, cfg, t, c, po)

    return Case(arch, shape, cfg, serve_step, (params, tok, caches, pos),
                mode=mode)
