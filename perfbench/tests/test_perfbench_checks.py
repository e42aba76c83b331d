"""The correctness check, driven through the rest of a run on the CPU at
test sizes (the harness's look for a card skipped): sound, the port's
round agrees with the plain reference; with the control (the program's
bf16 master weights) or any planted fault, ``correct`` comes out false."""
import time
from contextlib import nullcontext

import pytest
import torch

from perfbench import faults, inputs, manifest
from perfbench.inputs import param_spec
from perfbench.reference import genqsgd
from perfbench.reference.tree import leaves
from perfbench.tests.cells import CELLS, small

#: the limits of the check at these sizes (the cells' own limits were set
#: from full-width readings on the card; at these widths a leaf holds a few
#: hundred values and one flipped level moves its norm by up to ~1 %)
LIMITS = {"loss_gap": 5e-3, "update_gap": 0.05, "change_gap": 0.05}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell: str, fault=None, master=None, seed=2 ** 31 + 11):
    spec = small(cell)
    spec["job"]["limits"] = LIMITS
    if master:
        spec["config"]["precision"]["master"] = master
    drv = manifest.runner(spec["traffic"]["runner"])
    n_leaves = len(leaves(param_spec(spec["config"])))
    with faults.FAULTS[fault](n_leaves) if fault else nullcontext():
        return drv.run(spec, seed, 0.0, False, "cpu", time.time())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["values"]) == {"round_ms", "peak_mem_gib", "setup_s"}


def test_conditions_name_every_reading():
    """What a run records of the host and the card beside its metrics:
    the process's share of a core over the window, and each of the
    card's readings (None where ``nvidia-smi`` cannot be read)."""
    drv = manifest.runner("fed_round")
    cond = drv.conditions(1.5, 2.0)
    assert cond["host_cpu_share"] == pytest.approx(0.75)
    assert {"loadavg_1m", "host_cores", *drv._SMI_FIELDS} <= set(cond)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = run(cell, master="bfloat16")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    out = run(cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_blocks_agree(cell):
    """The reference's step over blocks of one row gives the loss and the
    change of the step over the whole batch at once (in f32, where only
    the order of the sums differs)."""
    spec = small(cell)
    cfg, job, traffic = spec["config"], spec["job"], spec["traffic"]
    like = param_spec(cfg)
    x0 = [inputs.make_leaf(leaf, 5, i, "cpu")
          for i, leaf in enumerate(leaves(like))]

    def follow(rows):
        return genqsgd.rounds(
            inputs.reference_model(cfg), cfg, like, x0,
            lambda r: inputs.round_batch(cfg, job, 5, r, "cpu"),
            lambda r: inputs.round_words(5, r, job["fl"]), traffic["gamma"],
            dict(job, reference_rows=rows), traffic["s0"], traffic["sn"], 2,
            torch.float32)
    whole, blocks = follow(job["batch"]), follow(1)
    assert whole["loss"] == pytest.approx(blocks["loss"], rel=1e-5)
    assert whole["grad"] == pytest.approx(blocks["grad"], rel=1e-4)
    for a, b in zip(whole["change"], blocks["change"]):
        assert a == pytest.approx(b, rel=1e-3)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_check_on_the_card(card, cell):
    """The same at test sizes on the card, through K1-K3 themselves: the
    sound run is correct, the control is not."""
    spec = small(cell)
    spec["job"]["limits"] = LIMITS
    drv = manifest.runner(spec["traffic"]["runner"])
    assert drv.run(spec, 7, 0.0, False, card, time.time())["correct"]
    spec["config"]["precision"]["master"] = "bfloat16"
    assert not drv.run(spec, 7, 0.0, False, card, time.time())["correct"]
