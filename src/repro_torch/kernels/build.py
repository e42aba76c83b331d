"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into
``<repo>/build/lib<name>-<hash>.so`` (the hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source rebuilds
and a stale library is never loaded)
for ``sm_90a``, with a plain C interface: pointers and the CUDA stream go
in as ``c_void_p``, every entry point returns ``cudaGetLastError()``, and
:func:`launch` raises on anything but 0.  Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load", "build",
           "launch"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
#: ``build/`` at the root of the checkout (``src/repro_torch`` -> ``.``)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build")
#: no --use_fast_math: the quantizer keeps IEEE division and sqrt
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
_FNS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def build(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` unless its library exists already.

    -> ``(path, seconds, compiler_output)``; seconds is 0.0 when nothing
    was compiled."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _, _ = build(name)
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib


def launch(lib: str, name: str, argtypes, *args) -> None:
    """Call the entry point ``name`` of ``csrc/<lib>.cu`` with ``args`` on
    PyTorch's current stream (``argtypes`` exclude the stream); a CUDA
    error at launch, such as a refused launch configuration, raises."""
    import torch
    fn = _FNS.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]   # + the stream
        fn.restype = ctypes.c_int
        _FNS[(lib, name)] = fn
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
