"""Flash decode (K6): single-token GQA attention against a KV cache,
hand-written in CUDA for Hopper (``csrc/flash_decode.cu``), with its launch
wrapper and plain PyTorch version.

  K6 :func:`flash_decode`  replaces ``repro/kernels/flash_decode.py``
                           ``_flash_decode_kernel`` / ``flash_decode_call``

q (B, KV, G, dh) attends over k/v (B, C, KV, dh) where ``valid`` (B, C) is
nonzero: scores (q . k) / sqrt(dh) in f32, masked ones set to -1e30, a
softmax over C in f32, the weighted sum of v in f32, the result in q's
type.  A row with no valid entry gets uniform weights (the mean of v).
Head h = kv * G + g of the model is (kv, g) here, the JAX package's
grouping.

What bounds it: every cache entry is read once with about 4G flops per
element, so device-memory bandwidth (3.35 TB/s on an H100 SXM) does: at
qwen3-1.7b's serving shape (8 slots x 4096 positions x 8 kv heads x 128,
bf16) a call moves 134 MB.  The kernel splits the cache across blocks
(split-K flash decoding) and merges the f32 partials in a second kernel in
a fixed order, so B * KV = 64 (b, kv) pairs still fill the 132 SMs and the
result is the same from run to run.  It takes any C (the TPU kernel asked
for a multiple of 512): each block masks its own ragged edge.

q is f32 or bf16, k and v f32 or bf16 (one type for both), G <= 16 and
dh in {64, 128, 256}, which covers every config of the JAX package.  The
wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors — only because the tensors lie on the CPU; a CUDA tensor never
falls back.  ``LAUNCHES`` counts wrapper calls that launched the kernel
(one call launches the split and the combine kernels).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .qsgd import _on_card

__all__ = ["LAUNCHES", "reset_launches", "CHUNK", "MAX_G", "HEAD_DIMS",
           "flash_decode", "flash_decode_plain"]

#: kernel launches per wrapper (the plain version never counts)
LAUNCHES = {"flash_decode": 0}

#: cache positions per block of the split kernel: ceil(C / CHUNK) splits
CHUNK = 256
MAX_G = 16
HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argument types of the C entry point in csrc/flash_decode.cu, stream
#: excluded
_SIG = ([_PTR] * 4 + [_INT] * 4 + [_LL, _LL] + [_INT] * 3 + [_PTR] * 3)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The dense softmax in f32: the oracle of the JAX package's own test
    (``tests/kernels/test_flash_decode.py``), cast to q's type as the
    kernel's output is."""
    dh = q.shape[-1]
    s = torch.einsum("bhgd,bchd->bhgc", q.float(), k.float()) / math.sqrt(dh)
    s = s.masked_fill(~(valid[:, None, None, :] > 0), -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgc,bchd->bhgd", w, v.float()).to(q.dtype)


def _check(q, k, v, valid):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or valid.shape != (k.shape[0], k.shape[1]) \
            or q.shape[0] != k.shape[0] or q.shape[1] != k.shape[2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_decode: want q (B, KV, G, dh), k/v "
                         f"(B, C, KV, dh), valid (B, C); got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} valid {tuple(valid.shape)}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"flash_decode: q f32/bf16 and k, v of one type "
                         f"f32/bf16; got {q.dtype} {k.dtype} {v.dtype}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """K6: q (B, KV, G, dh), k/v (B, C, KV, dh), valid (B, C) (nonzero =
    attend) -> (B, KV, G, dh) in q's type."""
    _check(q, k, v, valid)
    if not _on_card(q, k, v, valid):
        return flash_decode_plain(q, k, v, valid)
    B, KV, G, dh = q.shape
    C = k.shape[1]
    if dh not in HEAD_DIMS or not 1 <= G <= MAX_G or C < 1 \
            or not 1 <= B <= _MAX_GRID_YZ or not 1 <= KV <= _MAX_GRID_YZ:
        raise ValueError(f"flash_decode: the kernel takes dh in {HEAD_DIMS}, "
                         f"G <= {MAX_G}, B and KV <= {_MAX_GRID_YZ}; got "
                         f"{tuple(q.shape)} against C={C}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and "
                             f"16-byte aligned")
    if valid.dtype != torch.bool:
        valid = valid > 0
    valid = valid.contiguous()
    splits = -(-C // CHUNK)
    part_ml = torch.empty(B * KV * splits * G * 2, dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty(B * KV * splits * G * dh, dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    build.launch("flash_decode", "flash_decode", _SIG, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), valid.data_ptr(), B, KV, G, dh,
                 C, CHUNK, splits, int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), part_ml.data_ptr(),
                 part_acc.data_ptr(), out.data_ptr())
    LAUNCHES["flash_decode"] += 1
    return out
