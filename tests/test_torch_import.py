"""repro_torch and chip_smoke.py import with jax and repro blocked: the port
stands on PyTorch alone."""
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

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
    "repro_torch.compress.elias", "repro_torch.compress.backends",
    "repro_torch.opt.structure", "repro_torch.opt.refresh",
    "repro_torch.opt.gp_batched", "repro_torch.opt.gia_fused",
    "repro_torch.api.sweep", "repro_torch.serve.planserver",
    "repro_torch.fed", "repro_torch.fed.runtime", "repro_torch.fed.transport",
    "repro_torch.train", "repro_torch.train.trainer",
    "repro_torch.train.checkpoint", "repro_torch.data.synthetic",
    "repro_torch.data.federated", "repro_torch.models.moe",
    "repro_torch.models.mamba2", "repro_torch.configs.olmoe_1b_7b",
    "repro_torch.configs.phi35_moe", "repro_torch.configs.zamba2_2_7b",
    "repro_torch.models.xlstm", "repro_torch.configs.xlstm_1_3b",
    "repro_torch.configs.qwen2_vl_7b", "repro_torch.configs.llama3_405b",
    "repro_torch.configs.mistral_large_123b", "repro_torch.models.whisper",
    "repro_torch.configs.whisper_tiny", "repro_torch.launch",
    "repro_torch.launch.specs", "repro_torch.launch.train",
    "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
    "repro_torch.launch.perf", "repro_torch.roofline",
    "repro_torch.roofline.analysis", "repro_torch.roofline.report")


def test_port_imports_without_jax_or_repro():
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORTS
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the slices was imported
    names = set(proc.stdout.split())
    assert len(names) >= 40, proc.stdout
    assert not set(_SLICE_MODULES) - names, set(_SLICE_MODULES) - names


def test_each_subpackage_imports_first():
    """Every subpackage imports in a fresh process as the first import of
    the port (``repro_torch.opt`` once failed there on a cycle through
    ``repro_torch.families``), with jax and repro blocked."""
    head = _BLOCKED_IMPORTS.split("import repro_torch\n")[0]
    src = os.path.join(ROOT, "src", "repro_torch")
    pkgs = sorted(d for d in os.listdir(src)
                  if os.path.isfile(os.path.join(src, d, "__init__.py")))
    assert "opt" in pkgs and "api" in pkgs

    def first(pkg):
        one = f"ROOT = {ROOT!r}\n" + head + f"\nimport repro_torch.{pkg}\n"
        return subprocess.run([sys.executable, "-c", one],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=120)

    with ThreadPoolExecutor(4) as pool:
        for pkg, proc in zip(pkgs, pool.map(first, pkgs)):
            assert proc.returncode == 0, (pkg, proc.stderr[-2000:])


def test_planserver_import_loads_no_model_stack():
    """As in the JAX package, plan serving never pulls the LM models or
    the token-serving engine (``repro_torch.serve`` loads both lazily)."""
    code = (f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORTS.split(
        "import repro_torch\n")[0] + "\nimport repro_torch.serve.planserver\n"
        "from repro_torch.serve import PlanServer\n"
        "print(sorted(m for m in sys.modules if m.startswith(("
        "'repro_torch.models', 'repro_torch.serve.engine'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_examples_import_without_jax_or_repro():
    """Every ``examples/torch/*.py`` loads (its module body, not its main)
    with jax and repro blocked, and pulls neither in."""
    head = _BLOCKED_IMPORTS.split("import repro_torch\n")[0]
    code = (f"ROOT = {ROOT!r}\n" + head + textwrap.dedent("""
        import glob, importlib.util, os
        paths = sorted(glob.glob(os.path.join(ROOT, "examples", "torch",
                                              "*.py")))
        for path in paths:
            spec = importlib.util.spec_from_file_location(
                "example_" + os.path.basename(path)[:-3], path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not leaked, leaked
        print(" ".join(os.path.basename(p) for p in paths))
    """))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["optimize_parameters.py", "quickstart.py",
                                   "serve_decode.py",
                                   "train_lm_federated.py"]
