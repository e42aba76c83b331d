"""The port's launch layer (``repro_torch.launch``) against ``repro.launch``:
the case table, the abstract batch and parameter trees, ``build_case`` on
fake tensors, and the training launcher's command line (the twin of
``test_train_launcher_cli``, ``tests/integration/test_distributed.py``)."""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs.base import INPUT_SHAPES as R_SHAPES
from repro.launch import specs as R_SPECS
from repro.models.registry import ARCH_IDS as R_ARCH_IDS
from repro.models.registry import get_config as r_get_config
from repro.models.registry import model_api as r_model_api

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.fed import tree_leaves
from repro_torch.launch import specs as SPECS
from repro_torch.launch import train as LT
from repro_torch.models.registry import ARCH_IDS, get_config, model_api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def test_arch_ids_and_shapes_match_repro():
    assert ARCH_IDS == R_ARCH_IDS
    assert list(INPUT_SHAPES) == list(R_SHAPES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_case_supported_matches_repro(arch):
    for name in INPUT_SHAPES:
        assert SPECS.case_supported(get_config(arch), INPUT_SHAPES[name]) \
            == R_SPECS.case_supported(r_get_config(arch), R_SHAPES[name])


def test_plan_tables_match_repro():
    assert SPECS.FL_SUB == R_SPECS.FL_SUB
    assert SPECS.MICROBATCH == R_SPECS.MICROBATCH
    assert {a: str(d).removeprefix("torch.")
            for a, d in SPECS.PARAM_DTYPE.items()} == \
        {a: jnp.dtype(d).name for a, d in R_SPECS.PARAM_DTYPE.items()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-vl-7b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("shape_name,lead", [("train_4k", (4, 3)),
                                             ("prefill_32k", ())])
def test_abstract_batch_matches_repro(arch, shape_name, lead):
    """Dense, VLM and enc-dec batches, with the training lead (fl, K) and
    without: the same keys, shapes and dtypes as ``repro``'s
    ``ShapeDtypeStruct``s, every leaf a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    ref = R_SPECS._abstract_batch(r_get_config(arch), R_SHAPES[shape_name],
                                  lead=lead)
    got = SPECS._abstract_batch(get_config(arch), INPUT_SHAPES[shape_name],
                                lead=lead)
    assert sorted(got) == sorted(ref)
    for k, sds in ref.items():
        assert tuple(got[k].shape) == tuple(sds.shape), k
        assert got[k].dtype == _DTYPES[jnp.dtype(sds.dtype).name], k
        assert isinstance(got[k], FakeTensor), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_repro_at_full_width(arch, dtype):
    """``abstract_params`` at the published widths: the reference's
    ``jax.eval_shape`` tree leaf for leaf (``jax.tree.leaves`` order),
    shapes and dtypes, nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensor
    rc = r_get_config(arch)
    ref = jax.tree.leaves(r_model_api(rc).abstract_params(
        rc, dtype=jnp.dtype(dtype)))
    cfg = get_config(arch)
    got = tree_leaves(model_api(cfg).abstract_params(cfg,
                                                     dtype=_DTYPES[dtype]))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == tuple(r.shape), i
        assert g.dtype == _DTYPES[jnp.dtype(r.dtype).name], i
        assert isinstance(g, FakeTensor), i


def _rss_kib() -> int:
    with open("/proc/self/status") as f:
        return int(re.search(r"VmRSS:\s+(\d+)", f.read()).group(1))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_case_allocates_nothing(arch):
    """Every supported (arch, shape) case builds on fake tensors: each
    argument leaf a ``FakeTensor`` (or the host's key words), the
    argument bytes those of the full config (1.6 TB for llama3-405b's
    decode), the process's resident memory unmoved."""
    from torch._subclasses.fake_tensor import FakeTensor
    cfg = get_config(arch)
    before = _rss_kib()
    for name, shape in INPUT_SHAPES.items():
        if SPECS.case_supported(cfg, shape):
            with pytest.raises(ValueError, match="unsupported"):
                SPECS.build_case(arch, name)
            continue
        case = SPECS.build_case(arch, name)
        leaves = SPECS._leaves(case.args)
        assert all(isinstance(t, (FakeTensor, np.ndarray)) for t in leaves)
        n_params = sum(t.numel() for t in tree_leaves(case.args[0]))
        assert case.argument_bytes() >= n_params * 2
        assert (case.fed is not None) == (shape.kind == "train")
        if case.fed is not None:
            assert case.fed.n_workers == SPECS.FL_SUB[arch]
            assert case.fed.microbatch == SPECS.MICROBATCH.get(arch, 1)
    assert _rss_kib() - before < 512 * 1024


_CLI = ["--arch", "qwen3-1.7b", "--smoke", "--rounds", "3", "--batch", "4",
        "--seq", "64", "--wire", "int8", "--device", "cpu"]


def test_train_launcher_cli_bitwise_a_hand_built_trainer(capsys):
    """``python -m repro_torch.launch.train`` with the reference test's
    arguments prints ``[train] done``; its losses and final params are
    bitwise those of a ``GenQSGDTrainer`` built by hand from the same
    arguments."""
    from repro_torch.core.step_rules import make_rule
    from repro_torch.data.federated import round_batches
    from repro_torch.data.synthetic import token_batches
    from repro_torch.fed import FedConfig, LocalTransport
    from repro_torch.models import lm
    from repro_torch.train.trainer import GenQSGDTrainer

    got = LT.main(_CLI)
    out = capsys.readouterr().out
    assert "[train] done" in out and "fl=2 on cpu" in out, out
    cfg = get_config("qwen3-1.7b", smoke=True)
    fed = FedConfig(n_workers=2, Kn=(2, 2), s0=64, sn=64, wire="int8")
    trainer = GenQSGDTrainer(lm, cfg, fed, LocalTransport(2),
                             make_rule("C", 0.01), None, "cpu")
    state = trainer.init(0)
    batches = round_batches(token_batches(seed=0, batch=4, seq=64,
                                          vocab=cfg.vocab), 2, 2)
    ref = trainer.run(state, batches, 1, n_rounds=3, log_every=1)
    assert [h["loss"] for h in got.history] == \
        [h["loss"] for h in ref.history]
    for a, b in zip(tree_leaves(got.params), tree_leaves(ref.params)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("argv,match", [
    (["--fsdp", "2"], "--fsdp 2"), (["--tp", "2"], "--tp 2"),
    (["--arch", "whisper-tiny", "--smoke"], "enc-dec archs train via "
                                            "examples")])
def test_train_launcher_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        LT.main(argv + ["--device", "cpu"])


def test_train_launcher_s_defaults_match_repro():
    from repro.compress import RUNTIME_WIRES as R_WIRES
    from repro.compress import wire_max_s as r_wire_max_s
    from repro_torch.compress import RUNTIME_WIRES
    assert tuple(RUNTIME_WIRES) == tuple(R_WIRES)
    for w in R_WIRES:
        assert LT.default_s(w) == min(64, r_wire_max_s(w) or 64), w


def _options(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])(--?[a-z][\w-]*)", help_text))


def test_train_launcher_options_match_repro():
    """Both launchers' ``--help`` option sets agree, but for ``repro``'s
    ``--devices`` (an XLA host device count), which is ``--device``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-m", "repro.launch.train",
                          "--help"], capture_output=True, text=True,
                         env=env, timeout=120, cwd=ROOT)
    assert ref.returncode == 0, ref.stderr
    ap = LT.parser()
    r_opts = _options(ref.stdout)
    opts = _options(ap.format_help().replace(ap.prog, ""))
    assert r_opts - opts == {"--devices"}
    assert opts - r_opts == {"--device"}


def test_token_batches_walk_the_dense_matrix():
    """The launcher's data: the Markov walk that builds its current
    tokens' rows as it steps gives the tokens of a walk over the whole
    ``_markov_matrix`` (vocab^2 float64, 185 GB at qwen3's vocab), draw
    for draw."""
    from repro_torch.data import synthetic as SYN
    vocab, batch, seq = 97, 3, 40
    cum = np.cumsum(SYN._markov_matrix(vocab, 0), axis=1)
    gen = torch.Generator().manual_seed(0)
    stream = SYN.token_batches(0, batch, seq, vocab)
    for _ in range(3):
        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        rng = np.random.default_rng(seed)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(seq):
            u = rng.random(batch)
            toks[:, t + 1] = (cum[toks[:, t]] > u[:, None]).argmax(axis=1)
        got = next(stream)
        assert np.array_equal(got["tokens"].numpy(), toks[:, :-1])
        assert np.array_equal(got["labels"].numpy(), toks[:, 1:])
