"""Parameter-tree checkpoints in the JAX package's file format
(``repro/train/checkpoint.py``): a 4-byte magic, then a compressed msgpack
map from each leaf's path (``"segments/0/attn/wq"``) to ``{"dtype",
"shape", "data"}`` (raw C-order bytes), plus ``"__meta__"``.

The port writes ``RZL1`` (zlib).  It reads ``RZL1``, and ``RZS1`` (zstd)
where ``zstandard`` is installed; without it a zstd file raises as in the
JAX package.  The msgpack subset the format uses (maps, arrays, strings,
bytes, integers, floats, booleans and nil) is encoded and decoded here, so
no ``msgpack`` package is needed: a file either package writes loads in
the other.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..fed.runtime import tree_unflatten

try:
    import zstandard
except ImportError:  # optional extra; zstd files then refuse to load
    zstandard = None

__all__ = ["save", "load", "tree_paths"]

_MAGIC_ZSTD = b"RZS1"
_MAGIC_ZLIB = b"RZL1"

#: dtype names of the format (NumPy's, with ml_dtypes' bfloat16)
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------
def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(struct.pack(">B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif 0 <= obj < 1 << 64:
            out.append(b"\xcf" + struct.pack(">Q", obj))
        elif -(1 << 63) <= obj < 0:
            out.append(b"\xd3" + struct.pack(">q", obj))
        else:
            raise OverflowError(f"integer {obj} outside 64 bits")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_head(len(b), 0xA0, 32, b"\xd9", b"\xda", b"\xdb"))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_head(len(b), None, 0, b"\xc4", b"\xc5", b"\xc6"))
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, None, b"\xdc", b"\xdd"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, None, b"\xde", b"\xdf"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj)}")


def _head(n: int, fix, fix_max: int, h8, h16, h32) -> bytes:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit."""
    if fix is not None and n < fix_max:
        return struct.pack(">B", fix | n)
    if h8 is not None and n < 1 << 8:
        return h8 + struct.pack(">B", n)
    if n < 1 << 16:
        return h16 + struct.pack(">H", n)
    return h32 + struct.pack(">I", n)


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def unpackb(buf: bytes):
    obj, end = _unpack(memoryview(buf), 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} bytes after the msgpack object")
    return obj


_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
          0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
          0xD3: (">q", 8)}
_LEN = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4,
        0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4}


def _unpack(buf: memoryview, i: int):
    t = buf[i]
    i += 1
    if t < 0x80:
        return t, i
    if t >= 0xE0:
        return t - 0x100, i
    if t in _FIXED:
        fmt, n = _FIXED[t]
        return struct.unpack(fmt, buf[i:i + n])[0], i + n
    if t == 0xC0:
        return None, i
    if t in (0xC2, 0xC3):
        return t == 0xC3, i
    if t in _LEN:
        w = _LEN[t]
        n = int.from_bytes(buf[i:i + w], "big")
        i += w
        kind = {0xD9: "s", 0xDA: "s", 0xDB: "s", 0xC4: "b", 0xC5: "b",
                0xC6: "b", 0xDC: "a", 0xDD: "a", 0xDE: "m", 0xDF: "m"}[t]
    elif 0xA0 <= t < 0xC0:
        n, kind = t & 0x1F, "s"
    elif 0x90 <= t < 0xA0:
        n, kind = t & 0x0F, "a"
    elif 0x80 <= t < 0x90:
        n, kind = t & 0x0F, "m"
    else:
        raise ValueError(f"msgpack type byte {t:#x} is outside the "
                         f"checkpoint format")
    if kind == "s":
        return str(buf[i:i + n], "utf-8"), i + n
    if kind == "b":
        return bytes(buf[i:i + n]), i + n
    if kind == "a":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------
def _compress(raw: bytes) -> bytes:
    return _MAGIC_ZLIB + zlib.compress(raw, level=3)


def _decompress(blob: bytes) -> bytes:
    magic, body = blob[:4], blob[4:]
    if magic == _MAGIC_ZSTD:
        if zstandard is None:
            raise RuntimeError("checkpoint was written with zstandard, "
                               "which is not installed")
        return zstandard.ZstdDecompressor().decompress(body)
    if magic == _MAGIC_ZLIB:
        return zlib.decompress(body)
    # pre-magic checkpoints were raw zstd frames
    if zstandard is None:
        raise RuntimeError("legacy zstd checkpoint needs zstandard installed")
    return zstandard.ZstdDecompressor().decompress(blob)


def tree_paths(tree) -> dict:
    """Leaf path ("a/0/b") -> leaf, in ``jax.tree.leaves`` order."""
    flat = {}

    def visit(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t):
                visit(prefix + (str(k),), t[k])
        elif isinstance(t, (list, tuple)):
            for j, v in enumerate(t):
                visit(prefix + (str(j),), v)
        else:
            flat["/".join(prefix)] = t
    visit((), tree)
    return flat


def save(path: str, tree: Any, metadata: dict | None = None):
    """Write ``tree`` (tensors, copied to the host) and ``metadata``."""
    payload = {"__meta__": metadata or {}}
    for k, v in tree_paths(tree).items():
        t = torch.as_tensor(v).detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy().tobytes()
        payload[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                      "data": raw}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_compress(packb(payload)))


def _tensor(entry) -> torch.Tensor:
    dt = _DTYPES[entry["dtype"]]
    shape = tuple(entry["shape"])
    if dt == torch.bfloat16:
        a = np.frombuffer(entry["data"], np.int16).copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    a = np.frombuffer(entry["data"], np.dtype(entry["dtype"])).copy()
    return torch.from_numpy(a).reshape(shape)


def load(path: str, like: Any | None = None, device="cuda"):
    """-> (path -> tensor dict, metadata), or with ``like`` a tree shaped
    like it; tensors on ``device`` (the card unless the caller asks for the
    CPU; with no card it raises)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = unpackb(_decompress(f.read()))
    meta = payload.pop("__meta__", {})
    arrays = {k: _tensor(v).to(dev) for k, v in payload.items()}
    if like is None:
        return arrays, meta
    return tree_unflatten(like, [arrays[k] for k in tree_paths(like)]), meta
