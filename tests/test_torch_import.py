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
    print(len(names))
""")


def test_port_imports_without_jax_or_repro():
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORTS
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the slice was imported
    assert int(proc.stdout.split()[-1]) >= 30, proc.stdout
