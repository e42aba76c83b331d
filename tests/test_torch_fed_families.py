"""The federated GenQSGD round of repro_torch at the MoE, hybrid, xLSTM,
VLM and whisper smoke configs (olmoe-1b-7b, zamba2-2.7b, xlstm-1.3b,
qwen2-vl-7b and whisper-tiny) against the JAX package's, on the CPU, with
the real loss: the router's aux term (``FedConfig.aux_weight``) for olmoe,
the mamba2 blocks and zamba2's weight-shared attention for zamba2, the
mLSTM and sLSTM blocks for xlstm, for qwen2-vl patch embeddings and
unequal M-RoPE streams at ``microbatch`` 2 (positions3 (3, B, S) split on
its batch axis, as the reference splits it), and for whisper the encoder
over f32 frames, whose products with the bf16 view's weights promote to
f32, at ``microbatch`` 1 and 2 (the frames split on axis 0).

The JAX package's ``make_round_fn`` runs the cases of
``tests/torch_fed_cases.py``'s ``FAMILY_CASES`` on a (2, 1, 1) CPU mesh in
one subprocess (``python -m tests.torch_fed_cases reference OUT.npz
families``); the port runs the same rounds from the same params and key
words.  Both train at the bf16 view of the f32 weights, whose gradients
differ by bf16 rounding (``tests/test_torch_train.py``).  So, as
``tests/test_torch_fed.py`` holds the dense rounds:
- the real loss, exact workers and server (s0 = sn = None, f32 wire): the
  update x̂' - x̂ within 5e-2 normwise of the reference's, the loss within
  1e-3, delta_norm within 5e-2 (relative);
- the stub loss (bf16-exact gradients) on the same trees through the int8
  wire (s0 = 64, sn = (16, 127)): the workers agree, so the aggregation is
  held: the server's levels equal (the update's sign pattern), the update
  within 1e-4 normwise, delta_norm within 1e-4, the loss within 1e-6.  The
  tolerances are wider than the dense stub rounds' 1e-6 because these
  trees have leaves of 2^18 coordinates whose aggregate takes a few
  distinct values: the two packages' server norms there differ by up to
  1.3e-5 (measured, f32 sums in another order), which scales the whole
  leaf's update.  whisper's stub round allows level flips as
  ``tests/test_torch_fed.py`` allows them in the dense stub rounds, at 1
  in 10^4 coordinates: a coordinate of the update off the reference's by
  more than 1e-4 relative is a flip, and the update within 1e-4 normwise
  elsewhere (one flip, of 853,504 coordinates, measured, in the encoder's
  ``wv``: there one level of the two packages' norms, which differ by
  7.2e-6 in their f32 sums, took another stochastic rounding).  A real loss
  through a quantized wire is not compared: its bf16 rounding flips
  stochastic levels, each worth ‖Δ‖/s (0.2 of the update normwise, measured);
- the leaves in ``jax.tree.leaves``' order, shapes equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.fed import tree_leaves, tree_unflatten
from tests import torch_fed_cases as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: stub rounds that allow level flips at <= 1 in 10^4 coordinates
FLIP_RULE = ("whisper_int8",)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fedfam") / "ref.npz")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")
           + os.pathsep + ROOT, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-m", "tests.torch_fed_cases",
                           "reference", out, "families"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _x_hat(ref, tree):
    from repro_torch.models.registry import get_config, model_api
    cfg = get_config(C.ARCHS[tree], smoke=True)
    like = model_api(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    n = len(tree_leaves(like))
    assert f"{tree}/x/{n - 1}" in ref and f"{tree}/x/{n}" not in ref
    leaves = [torch.from_numpy(ref[f"{tree}/x/{i}"]) for i in range(n)]
    assert [tuple(a.shape) for a in leaves] == \
        [tuple(a.shape) for a in tree_leaves(like)]
    return tree_unflatten(like, leaves)


@pytest.fixture(scope="module")
def port(ref):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: C.port_round(case, _x_hat(ref, case[1]), ref["keys"])
                for name, case in C.FAMILY_CASES.items()}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(C.FAMILY_CASES))
def test_family_round_matches_reference(ref, port, name):
    got, m = port[name]
    _, tree, api, _ = C.FAMILY_CASES[name]
    want = ref[f"{name}/x_new"]
    x0 = np.concatenate([ref[k].reshape(-1) for k in sorted(
        (k for k in ref if k.startswith(f"{tree}/x/")),
        key=lambda k: int(k.rsplit("/", 1)[1]))])
    d_got, d_ref = got - x0, want - x0
    assert np.linalg.norm(d_ref) > 0
    if api == "stub":
        np.testing.assert_array_equal(np.sign(d_got), np.sign(d_ref))
        keep = np.ones(got.shape, bool)
        if name in FLIP_RULE:
            keep = np.isclose(d_got, d_ref, rtol=1e-4, atol=0)
            assert int((~keep).sum()) <= got.size // 10**4, \
                int((~keep).sum())
        assert np.linalg.norm((d_got - d_ref)[keep]) <= \
            1e-4 * np.linalg.norm(d_ref)
        np.testing.assert_allclose(m["delta_norm"],
                                   ref[f"{name}/m/delta_norm"], rtol=1e-4)
        np.testing.assert_allclose(m["loss"], ref[f"{name}/m/loss"],
                                   rtol=1e-6)
        return
    assert np.linalg.norm(d_got - d_ref) <= 5e-2 * np.linalg.norm(d_ref), \
        np.linalg.norm(d_got - d_ref) / np.linalg.norm(d_ref)
    assert abs(float(m["loss"]) - float(ref[f"{name}/m/loss"])) <= 1e-3
    np.testing.assert_allclose(m["delta_norm"], ref[f"{name}/m/delta_norm"],
                               rtol=5e-2)
