"""repro_torch and chip_smoke.py import with jax and repro blocked: the port
stands on PyTorch alone."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path[:0] = [ROOT, ROOT + "/src"]
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not leaked, leaked
    print(" ".join(names))
""")

#: modules each slice added; the walk above must have imported them
_SLICE_MODULES = (
    "repro_torch.kernels.qsgd", "repro_torch.core.genqsgd",
    "repro_torch.kernels.fused_encode", "repro_torch.compress.rotation",
    "repro_torch.configs.base", "repro_torch.configs.qwen3_1_7b",
    "repro_torch.configs.gemma3_4b", "repro_torch.kernels.flash_decode",
    "repro_torch.models.blocks", "repro_torch.models.lm",
    "repro_torch.models.registry", "repro_torch.serve.engine",
    "repro_torch.api.registries", "repro_torch.kernels.elias",
    "repro_torch.compress.elias", "repro_torch.compress.backends")


def test_port_imports_without_jax_or_repro():
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORTS
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the slices was imported
    names = set(proc.stdout.split())
    assert len(names) >= 40, proc.stdout
    assert not set(_SLICE_MODULES) - names, set(_SLICE_MODULES) - names
