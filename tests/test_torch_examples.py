"""The example twins (``examples/torch/*.py``) run in-process on the CPU at
tiny arguments and print their final lines."""
import importlib.util
import os
import runpy
import sys

import pytest

from repro_torch.configs.base import ArchConfig

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "torch")


def _run(monkeypatch, capsys, name, argv):
    """``python examples/torch/<name>.py <argv>`` in this process -> the
    lines it printed."""
    path = os.path.join(EXAMPLES, f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + argv)
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out.strip().splitlines()


def test_quickstart(monkeypatch, capsys):
    out = _run(monkeypatch, capsys, "quickstart",
               ["--device", "cpu", "--max-rounds", "3", "--probe-iters",
                "24"])
    assert out[-1].startswith("== done: final accuracy"), out[-5:]
    assert "(3 of " in out[-1]


@pytest.mark.parametrize("argv", [["--backend", "numpy"],
                                  ["--backend", "numpy", "--h100"]])
def test_optimize_parameters(monkeypatch, capsys, argv):
    out = _run(monkeypatch, capsys, "optimize_parameters",
               ["--device", "cpu"] + argv)
    assert out[0].startswith("T_max=") and "numpy backend" in out[0]
    assert out[-1].startswith("PR-SGD" if "--h100" in argv else "FedAvg")


def test_optimize_parameters_refuses_jnp(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        _run(monkeypatch, capsys, "optimize_parameters",
             ["--device", "cpu", "--backend", "jnp"])


@pytest.mark.parametrize("argv,last", [
    ([], "decoded 4 tokens x 4 sequences"),
    (["--arch", "whisper-tiny"], "decoded 4 tokens x 4 sequences"),
    (["--arch", "qwen2-vl-7b"], "decoded 4 tokens x 4 sequences"),
    (["--engine", "--requests", "5"], "served 5 requests over 4 slots")])
def test_serve_decode(monkeypatch, capsys, argv, last):
    out = _run(monkeypatch, capsys, "serve_decode",
               ["--device", "cpu", "--steps", "4"] + argv)
    assert out[-1].startswith(last), out[-3:]


def test_train_lm_federated(monkeypatch, capsys):
    """The example's main path (Plan -> FedConfig -> GenQSGDTrainer over
    two local workers, int8 wire) with its model cut to a tiny width: the
    CPU encodes lm-10m's 4.5 M coordinates' noise slowly."""
    path = os.path.join(EXAMPLES, "train_lm_federated.py")
    spec = importlib.util.spec_from_file_location("train_lm_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tiny = ArchConfig(name="lm-tiny", family="dense", citation="example",
                      n_layers=2, d_model=64, n_heads=2, n_kv=1, d_ff=128,
                      vocab=256, d_head=32)
    monkeypatch.setattr(mod, "small_cfg", lambda full: tiny)
    mod.main(["--device", "cpu", "--rounds", "3", "--seq", "16",
              "--batch", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("model lm-tiny") and "fl=2 on cpu" in out[0]
    assert out[-1].startswith("loss: ") and "over 3 rounds" in out[-1]
