"""What the benchmark's process holds: a run at test sizes, with the JAX
package and JAX blocked from import, loads neither; the plain references
load nothing of the port; the run's own guard names what it finds by whole
top-level names."""
import os
import subprocess
import sys
import textwrap
import types

from perfbench import manifest

ROOT = manifest.ROOT

BLOCK = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path[:0] = [ROOT, ROOT + "/src"]
""")


def _run(blocked, body):
    code = (f"ROOT = {ROOT!r}\nBLOCKED = {blocked!r}\n" + BLOCK
            + textwrap.dedent(body))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_a_run_loads_no_jax():
    out = _run(("jax", "jaxlib", "flax", "repro"), """
        import time
        import torch
        torch.set_num_threads(1)
        from perfbench import manifest, run
        from perfbench.tests.cells import small
        spec = small("qwen3-1.7b.fed-int8")
        spec["job"]["limits"] = {"loss_gap": 5e-3, "update_gap": 0.05,
                                 "change_gap": 0.05}
        drv = manifest.runner(spec["traffic"]["runner"])
        out = drv.run(spec, 3, 0.0, False, "cpu", time.time())
        assert out["correct"], out["checks"]
        print("leaked", run.forbidden_modules())
    """)
    assert out.strip().splitlines()[-1] == "leaked []"


def test_references_load_nothing_of_the_port():
    out = _run(("jax", "jaxlib", "flax", "repro", "repro_torch"), """
        import torch
        from perfbench import inputs
        from perfbench.reference import genqsgd, lm, ops, tree, whisper
        from perfbench.tests.cells import small
        spec = small("whisper-tiny-style.fed-int8")
        like = inputs.param_spec(spec["config"])
        w = inputs.make_weights(spec["config"], 1, "cpu")
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] == "repro_torch"))
    """)
    assert out.strip().splitlines()[-1] == "[]"


def test_guard_compares_whole_top_level_names(monkeypatch):
    from perfbench import run
    for name in ("repro_torch", "repro_torch.fed", "reproducible", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = run.forbidden_modules()
    assert not {"repro_torch", "repro_torch.fed", "reproducible",
                "jaxtyping"} & set(found)
    monkeypatch.setitem(sys.modules, "repro.fed", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("x"))
    assert {"repro.fed", "flax"} <= set(run.forbidden_modules())
