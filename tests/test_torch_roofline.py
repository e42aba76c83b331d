"""The port's roofline layer (``repro_torch.roofline``,
``repro_torch.launch.{dryrun,roofline}``) against ``repro.roofline``: the
arithmetic equal to the reference's (an ``HW`` built from ``TPU_V5E``'s
fields), ``EdgeSystem.h100_fleet`` given the TPU figures equal to
``tpu_v5e_fleet``, the dry-run and roofline records of two cases with
their counts held to closed forms, and the report tables."""
import dataclasses
import json

import numpy as np
import pytest
from repro.core.cost import EdgeSystem as R_EdgeSystem
from repro.roofline import analysis as RA

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core.cost import EdgeSystem
from repro_torch.fed import tree_leaves
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as SPECS
from repro_torch.models.registry import get_config
from repro_torch.roofline import analysis as A
from repro_torch.roofline import report

TPU = A.HW(*dataclasses.astuple(RA.TPU_V5E))


@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (3.1e15, 2.2e12, 0.0, 1), (1e9, 4e12, 7e11, 256), (5e18, 1.0, 3e13, 8),
    (0.0, 0.0, 1.0, 1)])
def test_roofline_terms_equal_repro(flops, nbytes, coll, chips):
    assert A.roofline_terms(flops, nbytes, coll, chips, hw=TPU) == \
        RA.roofline_terms(flops, nbytes, coll, chips)
    h = A.roofline_terms(flops, nbytes, coll, chips)
    assert h["compute_s"] == flops / (chips * 989e12)
    assert h["memory_s"] == nbytes / (chips * 3.35e12)
    assert h["collective_s"] == coll / (chips * 450e9)


def test_extrapolate_and_bandwidth_equal_repro():
    c1 = {"flops": 3.0e12, "bytes_accessed": 7.5e9, "x": 4.0}
    c2 = {"flops": 5.5e12, "bytes_accessed": 7.0e9, "y": 1.0}
    for reps in (1, 2, 27.5, 126):
        assert A.extrapolate(c1, c2, reps) == RA.extrapolate(c1, c2, reps)
    for n, s in ((1e9, 1e-3), (3.35e12, 1.0), (5.0, 0.0)):
        assert A.achieved_bandwidth(n, s) == RA.achieved_bandwidth(n, s)


@pytest.mark.parametrize("wire", ["int4", "int8"])
@pytest.mark.parametrize("pipeline", ["fused", "multipass"])
def test_encode_bytes_equal_repro(wire, pipeline):
    for n in (1, 101_770, 1 << 22, 352_321_536):
        assert A.encode_bytes(n, wire, pipeline) == \
            RA.encode_bytes(n, wire, pipeline)


def test_encode_bytes_refusals_equal_repro():
    for kw, match in (({"wire": "f32"}, "packed level wires"),
                      ({"pipeline": "twopass"}, "unknown pipeline")):
        for fn in (A.encode_bytes, RA.encode_bytes):
            with pytest.raises(ValueError, match=match):
                fn(1000, **kw)


def test_h100_fleet_given_tpu_figures_equals_tpu_v5e_fleet():
    """Field for field, bitwise: the arithmetic is ``repro``'s; only the
    defaults are the H100's."""
    kw = dict(dim=405_000_000_000, n_groups=2, chips_per_group=256,
              s0=1024, sn=1024, flops_per_sample_step=6 * 405e9 * 4096)
    got = EdgeSystem.h100_fleet(**kw, link_bw=50e9 * 8, peak_flops=197e12,
                                watts_per_chip=200.0)
    ref = R_EdgeSystem.tpu_v5e_fleet(**kw)
    for f in dataclasses.fields(R_EdgeSystem):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b or (a is None and b is None), f.name
    assert (got.M_s0, got.comm_time) == (ref.M_s0, ref.comm_time)
    h = EdgeSystem.h100_fleet(**kw)
    assert (h.F0, h.p0, h.r0) == (989e12 * 256 * 0.4, 700.0 * 256, 400e9)


def _decode_closed_form(cfg, B, S):
    """qwen3-1.7b's decode step at (B, S): argument bytes (bf16 params, a
    bf16 K/V cache with int32 positions and cursor a layer, int32 token
    and position), new output bytes (bf16 logits), and FLOPs (2 a weight
    a token through every projection and the tied head; q·K and p·V over
    all S positions of every layer)."""
    L, KV, dh, H = cfg.n_layers, cfg.n_kv, cfg.d_head, cfg.n_heads
    cache = L * (2 * B * S * KV * dh * 2 + B * S * 4 + B * 4)
    args = 2 * _tree_params(cfg) + cache + 2 * B * 4
    flops = B * (2 * _matmul_params(cfg) + L * 4 * S * H * dh)
    return args, B * cfg.vocab * 2, flops


def _tree_params(cfg):
    from repro_torch.models import lm
    return sum(t.numel() for t in tree_leaves(lm.abstract_params(cfg)))


def _matmul_params(cfg):
    """Weights a token meets in a product: every projection and the MLP a
    layer, and the tied head (the embedding gather is no product)."""
    D, H, KV, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                       cfg.d_ff)
    layer = D * H * dh * 2 + D * KV * dh * 2 + 3 * D * F
    return cfg.n_layers * layer + cfg.vocab * D


def test_dryrun_and_roofline_decode_32k_full_width():
    """qwen3-1.7b decode_32k at full width: the arguments (451 GiB of
    bf16 K/V cache) do not fit one card; bytes and FLOPs equal their
    closed forms exactly (the 28 layers counted at 1 and 2 repeats)."""
    cfg = get_config("qwen3-1.7b")
    shape = INPUT_SHAPES["decode_32k"]
    args, out, flops = _decode_closed_form(cfg, shape.global_batch,
                                           shape.seq_len)
    rec = dryrun.run_case("qwen3-1.7b", "decode_32k", verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "h100x1"
    assert rec["memory"]["argument_bytes"] == args
    assert rec["memory"]["output_bytes"] == out
    assert rec["memory"]["temp_bytes"] is None
    assert rec["fits"] is False and rec["card_bytes"] > 79 * 2**30
    assert rec["cost"]["flops"] == flops
    assert rec["collectives"]["total_bytes"] == 0
    assert rec["depth"].startswith("1 and 2 repeats")
    assert rec["param_count"] == cfg.param_count()
    r = roofline.roofline_case("qwen3-1.7b", "decode_32k")
    assert r["per_device"] == {"flops": float(flops),
                               "bytes_accessed": float(args + out),
                               "collective_bytes": 0.0}
    assert r["terms"]["dominant"] == "memory"
    assert r["terms"]["memory_s"] == (args + out) / 3.35e12
    assert r["model_flops"] == 2.0 * cfg.param_count(active_only=True) * 128


def test_dryrun_and_roofline_train_4k_smoke():
    """qwen3-smoke train_4k: the round's T tokens (fl · K_max workers'
    steps of B/fl × S) cost 6 FLOPs a weight a token (forward 2, backward
    4) plus 12·S·H·dh a token a layer for q·K and p·V (the port's
    attention computes every score and masks after): the counted FLOPs
    equal that within 0.1 % (the norms' weights, which no product
    touches, are in N)."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    shape = INPUT_SHAPES["train_4k"]
    n = _tree_params(cfg)
    for fn, k_local in ((dryrun.run_case, 2), (roofline.roofline_case, 1)):
        rec = fn("qwen3-1.7b", "train_4k", smoke=True)
        assert rec["status"] == "ok" and rec["counted"] == "local step"
        fl = SPECS.FL_SUB["qwen3-1.7b"]
        T = (k_local + 1) * shape.global_batch * shape.seq_len
        band = T * (6 * n + 12 * cfg.n_layers * shape.seq_len
                    * cfg.n_heads * cfg.d_head)
        flops = rec["cost"]["flops"] if fn is dryrun.run_case \
            else rec["flops_counted"]
        assert abs(flops / band - 1) < 1e-3, (flops, band)
        assert rec["fl_axis"] == fl
    r = rec
    assert r["model_flops"] == 6.0 * cfg.param_count() * shape.global_batch \
        * shape.seq_len
    assert r["useful_flops_ratio"] == r["model_flops"] / r["flops_counted"]


def test_step_count_equals_the_whole_round(monkeypatch):
    """Counting one local step times fl·K_max equals running the whole
    round on the fake tensors (every worker, every step, virtual ones
    included, and the aggregate), at qwen3-smoke on a short training shape
    with fl = 2 workers of Kn = (1, 2)."""
    from repro_torch.configs.base import InputShape
    shapes = dict(INPUT_SHAPES, train_tiny=InputShape("train_tiny", 64, 16,
                                                      "train"))
    monkeypatch.setattr(SPECS, "INPUT_SHAPES", shapes)
    monkeypatch.setitem(SPECS.FL_SUB, "qwen3-1.7b", 2)
    case = SPECS.build_case("qwen3-1.7b", "train_tiny", smoke=True,
                            k_local=1)
    assert case.fed.Kn == (1, 2)
    step, whole = case.count(), case.count(whole_round=True)
    assert (step["counted"], whole["counted"]) == ("local step", "round")
    assert step["flops"] == whole["flops"]
    assert step["output_bytes"] == whole["output_bytes"]


def test_extrapolated_count_equals_full_depth():
    """gemma3-smoke cut to 11 layers (3 patterns of 3 and a 2-layer tail)
    counted at 1 and 2 repeats plus the tail equals the full-depth count."""
    cfg = dataclasses.replace(get_config("gemma3-4b", smoke=True),
                              n_layers=11)
    got = roofline.count_case("gemma3-4b", "decode_32k", cfg)
    full = SPECS.build_case("gemma3-4b", "decode_32k",
                            cfg_override=cfg).count()
    assert got["depth"] == "1 and 2 repeats, extrapolated (+ a 2-layer tail)"
    assert (got["flops"], got["output_bytes"]) == (full["flops"],
                                                   full["output_bytes"])


def test_report_tables_render_ok_and_skipped(tmp_path):
    skipped = {"arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "h100x1",
               "status": "skipped", "reason": "pure full-attention arch"}
    failed = {"arch": "x", "shape": "y", "mesh": "h100x1",
              "status": "FAILED", "error": "ValueError: z"}
    dry = [dryrun.run_case("qwen3-1.7b", "decode_32k", verbose=False),
           skipped, failed]
    roof = [roofline.roofline_case("qwen3-1.7b", "decode_32k"), skipped,
            failed]
    for name, recs in (("dry.json", dry), ("roof.json", roof)):
        with open(tmp_path / name, "w") as f:
            json.dump(recs, f)
    d = report.dryrun_table(str(tmp_path / "dry.json")).splitlines()
    r = report.roofline_table(str(tmp_path / "roof.json")).splitlines()
    assert len(d) == len(r) == 5
    assert d[2].endswith("| ok |") and "| no |" in d[2]
    assert "skipped: pure full-attention arch" in d[3]
    assert "FAILED: ValueError: z" in d[4]
    assert "**memory**" in r[2] and "| skipped |" in r[3]
    assert "| FAILED |" in r[4]
