"""The harness is driven by data: on a copy of the benchmark, a new
configuration, traffic mix, cell and per-layer metric come in as new files
and manifest entries, and the harness finds each by name with no file of
the copy edited.  The committed manifest keeps the naming rules, and each
configuration's ``arch`` block (what the port runs) states the published
sizes beside it."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import manifest
from perfbench.tests.cells import LM, LM_ARCH

ROOT = manifest.ROOT


def _digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.fixture
def copy(tmp_path):
    """A checkout holding a copy of the benchmark and ``BENCHMARK.json``,
    with a link to the port's sources."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    (tmp_path / "src").symlink_to(os.path.join(ROOT, "src"))
    return tmp_path


def _add(root):
    """A configuration, a mix, a cell and a metric, by new files and new
    manifest entries only."""
    bench = root / "perfbench"
    with open(bench / "configs" / "qwen3-1.7b.json") as f:
        cfg = json.load(f)
    cfg.update(LM, name="qwen3-tiny")
    cfg["arch"].update(LM_ARCH, name="qwen3-tiny")
    (bench / "configs" / "qwen3-tiny.json").write_text(json.dumps(cfg))
    with open(bench / "traffic" / "fed-int8.json") as f:
        mix = json.load(f)
    mix.update(s0=32, sn=32)
    (bench / "traffic" / "fed-int8-s32.json").write_text(json.dumps(mix))
    job = {"config": "qwen3-tiny", "traffic": "fed-int8-s32", "fl": 2,
           "Kn": [1, 1], "batch": 2, "seq": 8, "check_rounds": 2,
           "trace_rounds": 1,
           "limits": {"loss_gap": 5e-3, "update_gap": 0.05,
                      "change_gap": 0.05}}
    (bench / "workloads" / "qwen3-tiny.fed-int8-s32.json").write_text(
        json.dumps(job))
    (bench / "metrics" / "rounds_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['rounds'])\n")
    m = manifest.load(str(root))
    m["configs"].append({"name": "qwen3-tiny", "source": cfg["source"],
                         "file": "perfbench/configs/qwen3-tiny.json",
                         "reduced": ["hidden_size"], "why": "a test"})
    m["workloads"].append({"name": "qwen3-tiny.fed-int8-s32",
                           "config": "qwen3-tiny", "traffic": "fed-int8-s32",
                           "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "rounds_traced", "unit": "rounds",
                           "better": "higher", "source": "device_trace",
                           "layer": "trainer loop", "moves": "round_ms",
                           "workloads": ["qwen3-tiny.fed-int8-s32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return m


def test_new_files_are_found_by_name(copy):
    before = _digests(copy / "perfbench")
    m = _add(copy)
    after = _digests(copy / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
    bench = str(copy / "perfbench")
    spec = manifest.cell(manifest.load(str(copy)), "qwen3-tiny.fed-int8-s32",
                         bench)
    assert spec["config"]["hidden_size"] == LM["hidden_size"]
    assert spec["traffic"]["sn"] == 32 and spec["job"]["check_rounds"] == 2
    names = [x["name"] for x in
             manifest.metrics_of(m, "per_layer", "qwen3-tiny.fed-int8-s32")]
    assert "rounds_traced" in names and "mfu.train" in names
    assert "rounds_traced" not in [
        x["name"] for x in manifest.metrics_of(m, "per_layer",
                                               "qwen3-1.7b.fed-int8")]
    assert manifest.reader("rounds_traced", bench)({"rounds": 3}) == 3.0
    drv = manifest.runner(spec["traffic"]["runner"], bench)
    out = drv.run(spec, 5, 0.0, False, "cpu", time.time())
    assert out["correct"], out["checks"]


def test_run_resolves_the_new_cell(copy):
    _add(copy)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen3-tiny.fed-int8-s32", "--seed", "1",
                        "--seconds", "1"], cwd=copy, env=env,
                       capture_output=True, text=True, timeout=120)
    # found, then refused for want of a card: no result printed
    assert p.returncode == 2, p.stderr
    assert "qwen3-tiny.fed-int8-s32 needs 1 CUDA card" in p.stderr
    assert p.stdout == ""


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen3-1.7b.fed-int8", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_committed_names_and_units():
    m = manifest.load()
    assert manifest.name_problems(m) == []
    for kind in ("end_to_end", "per_layer"):
        for x in m[kind]:
            assert len(x["unit"]) <= 16 and manifest.UNIT.match(x["unit"])


def test_names_rules_catch_bad_names():
    m = {"configs": [{"name": "a b", "reduced": ["x/y"]}],
         "workloads": [{"name": "c", "config": "a b", "traffic": "t"},
                       {"name": "c", "config": "a", "traffic": "t"}],
         "end_to_end": [{"name": "m", "unit": "tokens per second"}],
         "per_layer": [{"name": "µs", "unit": "%"}]}
    bad = manifest.name_problems(m)
    assert len(bad) == 6, bad


@pytest.mark.parametrize("name", [c["name"] for c in manifest.load()["configs"]])
def test_config_arch_states_the_published_sizes(name):
    m = manifest.load()
    entry = next(c for c in m["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    arch = cfg["arch"]
    if cfg["reference"] == "lm":
        pairs = [("hidden_size", "d_model"), ("num_hidden_layers", "n_layers"),
                 ("num_attention_heads", "n_heads"),
                 ("num_key_value_heads", "n_kv"), ("head_dim", "d_head"),
                 ("intermediate_size", "d_ff"), ("vocab_size", "vocab"),
                 ("rope_theta", "rope_theta"), ("rms_norm_eps", "norm_eps"),
                 ("tie_word_embeddings", "tie_embeddings"),
                 ("qk_norm", "qk_norm")]
    else:
        pairs = [("d_model", "d_model"), ("decoder_layers", "n_layers"),
                 ("encoder_layers", "enc_layers"),
                 ("decoder_attention_heads", "n_heads"),
                 ("decoder_attention_heads", "n_kv"),
                 ("decoder_ffn_dim", "d_ff"), ("vocab_size", "vocab"),
                 ("max_source_positions", "max_source_positions"),
                 ("rope_theta", "rope_theta"), ("rms_norm_eps", "norm_eps")]
    for pub, port in pairs:
        assert cfg[pub] == arch[port], (pub, port)
    from perfbench.inputs import param_spec
    from perfbench.reference.tree import leaves
    assert sum(l.numel for l in leaves(param_spec(cfg))) == cfg["parameters"]
