"""The federated LM runtime of repro_torch (``repro_torch.fed``) against the
JAX package's (``repro.fed.runtime``) on the CPU.

- ``uniform_like`` and ``_seed_from``: bitwise over shapes and seeds.
- ``FedConfig``: the same refusals, message for message (the port's
  ``FaultSpec`` message names its own package), the same codecs.
- The round: every case of ``tests/torch_fed_cases.py`` through the JAX
  package's ``make_round_fn`` on a (2, 1, 1) CPU mesh (one subprocess, all
  cases saved to one ``.npz``) and through the port's, with the reference's
  key words injected.  Both train the same stub api, so their worker
  params are identical and the comparison holds the aggregation: the
  five wires, bucket 8, u-weighted, agg_weights, momentum/normalize and
  microbatch = 2.  x̂' within rtol/atol 1e-6 (the server's apply rounds
  x̂ + (γ·lvl)·(‖·‖/s) where the reference rounds x̂ + γ·(lvl·(‖·‖/s)));
  a coordinate outside that is a level flip, allowed at 1 in 10^4
  coordinates (norms within rtol 1e-6 can flip a level).  delta_norm
  within rtol 1e-5, the Elias stream bits equal.  One real-loss
  qwen3-smoke round (s0 = sn = None, f32 wire, bf16 view): the update
  x̂' - x̂ within 5e-2 normwise of the reference's (the bf16 gradients
  differ by bf16 rounding, ``tests/test_torch_train.py``), the loss
  within 1e-3.
- Within the port every wire gives the f32 wire's bits at the same
  quantizers.
- Two gloo ranks running every wire through ``DistTransport`` (one spawn)
  give ``LocalTransport``'s bits.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed.runtime as RR
import repro_torch.fed.runtime as PR
from repro.data import federated as RDF
from repro.data import synthetic as RDS
from repro_torch.data import federated as PDF
from repro_torch.data import synthetic as PDS
from repro_torch.fed import (FedConfig, LocalTransport,
                             tree_leaves, tree_unflatten, uniform_like)
from repro_torch.fed.runtime import _seed_from
from tests import torch_fed_cases as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")
            + os.pathsep + ROOT, "JAX_PLATFORMS": "cpu"}


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (1000, 33),
                                   (2, 3, 4, 5)])
@pytest.mark.parametrize("seed", [0, 1, 123456789, 2**31, 2**32 - 1])
def test_uniform_like_bitwise(shape, seed):
    ref = np.asarray(RR.uniform_like(jnp.zeros(shape), jnp.uint32(seed)))
    got = uniform_like(torch.zeros(shape), seed).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_uniform_like_in_pieces(monkeypatch):
    """The hash is elementwise over the flat index: a tensor generated in
    pieces has the bits of one piece."""
    whole = uniform_like(torch.zeros(1000), 9)
    monkeypatch.setattr(PR, "_NOISE_CHUNK", 77)
    assert torch.equal(uniform_like(torch.zeros(1000), 9), whole)


@pytest.mark.parametrize("key", [0, 1, 42, 2**31 - 1])
@pytest.mark.parametrize("salt", [0, 1, 12, 1000, 1012])
def test_seed_from_bitwise(key, salt):
    k = jax.random.PRNGKey(key)
    for words in (k, jax.random.split(k, 3)[2]):
        assert _seed_from(np.asarray(words), salt) == \
            int(RR._seed_from(words, salt))


def test_tree_leaves_order():
    """The reference's leaf order: dict keys sorted, lists in order."""
    t = C.stub_tree()
    assert [a.shape for a in tree_leaves(t)] == \
        [a.shape for a in jax.tree.leaves(t)]
    back = tree_unflatten(t, tree_leaves(t))
    assert jax.tree.structure(back) == jax.tree.structure(t)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(t, tree_leaves(t) + [0])


# ---------------------------------------------------------------------------
# FedConfig
# ---------------------------------------------------------------------------
def _faults(mod, N):
    fm = mod.edge_faults(straggler_prob=0.3, straggler_factor=4.0)
    wt = (1.0,) * N
    return mod.FaultSpec(model=fm, worker_times=wt, deadline=1.5,
                         deliver_p=tuple(fm.deliver_prob(np.asarray(wt),
                                                         1.5)))


_BAD = [
    dict(wire="bogus"),
    dict(agg_weights=(1.0,)),
    dict(momentum=1.0),
    dict(sampling_p=(0.5, 0.5)),
    dict(sampling_S=3),
    dict(sampling_S=2, sampling_p=(0.9, 0.1)),
    dict(sampling_S=1, wire="int8"),
    dict(sampling_S=1, wire="rs_ag", bucket=8),
    dict(faults="spec", wire="int8"),
    dict(faults="spec3"),
    dict(faults="spec", wire="rs_ag", bucket=8),
    dict(bucket=0),
    dict(wire="int4", s0=8, sn=7),
    dict(wire="elias", s0=128, sn=7),
    dict(wire="int8", s0=7, sn=(7, None)),
    dict(wire="int4", s0=None, sn=None),
    dict(faults="not-a-spec"),
]


@pytest.mark.parametrize("kw", _BAD, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items())[:40])
def test_fedconfig_refusals_equal(kw):
    import repro.faults as RF
    import repro_torch.faults as PF
    errs = []
    for mod, faults in ((RR, RF), (PR, PF)):
        k = {"s0": 16, "sn": 16, **kw}
        if k.get("faults") in ("spec", "spec3"):
            k["faults"] = _faults(faults, 3 if k["faults"] == "spec3"
                                  else 2)
        with pytest.raises((ValueError, TypeError)) as e:
            mod.FedConfig(n_workers=2, Kn=(1, 2), **k)
        errs.append((type(e.value), str(e.value)))
    assert errs[1][0] is errs[0][0]
    assert errs[1][1].replace("repro_torch.", "repro.") == errs[0][1]


@pytest.mark.parametrize("kw", [
    dict(s0=7, sn=(7, 5), wire="int4"), dict(s0=64, sn=16, wire="int8",
                                             bucket=4096),
    dict(s0=None, sn=None, wire="f32"), dict(s0=None, sn=7, wire="int4"),
    dict(s0=7, sn=(5, 7), wire="elias"), dict(s0=64, sn=16, wire="rs_ag",
                                              agg_weights=(3, 1))])
def test_fedconfig_equal(kw):
    r = RR.FedConfig(n_workers=2, Kn=(1, 3), **kw)
    p = FedConfig(n_workers=2, Kn=(1, 3), **kw)
    assert (p.K_max, p.sn_tuple(), p.sn_exact, p.agg_weights) == \
        (r.K_max, r.sn_tuple(), r.sn_exact, r.agg_weights)
    for d in (1000, 1312256):
        assert [c.wire_bits(d) for c in p.codecs()] == \
            [c.wire_bits(d) for c in r.codecs()]
        assert p.server_codec().wire_bits(d) == r.server_codec().wire_bits(d)


def test_fedconfig_faults_spec_accepted():
    import repro_torch.faults as PF
    fed = FedConfig(n_workers=2, Kn=(1, 1), s0=16, sn=16,
                    faults=_faults(PF, 2), seed=3)
    assert fed.faults.N == 2 and fed.faults.model.key == "edge"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seed", [(64, 0), (100, 3)])
def test_markov_matrix_equal(vocab, seed):
    assert np.array_equal(PDS._markov_matrix(vocab, seed),
                          RDS._markov_matrix(vocab, seed))


def test_round_batches_layout():
    """(fl, K_max, B, S), worker-major, as the reference stacks them."""
    def stream(lib):
        i = 0
        while True:
            i += 1
            yield {"tokens": lib.full((2, 3), i)}
    ref = next(RDF.round_batches(stream(jnp), 2, 3))["tokens"]
    got = next(PDF.round_batches(stream(torch), 2, 3))["tokens"]
    assert got.shape == (2, 3, 2, 3)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_token_batches_walk_the_markov_chain():
    b = next(PDS.token_batches(0, 3, 16, 32))
    assert b["tokens"].shape == (3, 16) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    u = PDS.uniform_lm_batch(torch.Generator().manual_seed(0), (2, 1, 3, 8),
                             50)
    assert u["tokens"].shape == (2, 1, 3, 8)
    assert torch.equal(u["tokens"][..., 1:], u["labels"][..., :-1])


# ---------------------------------------------------------------------------
# the round against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fed") / "ref.npz")
    proc = subprocess.run([sys.executable, "-m", "tests.torch_fed_cases",
                           "reference", out], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _x_hat(ref, tree):
    if tree == "stub":
        return C.stub_params()
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import lm as PLM
    from repro_torch.models.registry import get_config
    cfg = (ArchConfig(**C.TINY) if tree == "tiny"
           else get_config("qwen3-1.7b", smoke=True))
    like = PLM.init_params(cfg, torch.Generator().manual_seed(0))
    return tree_unflatten(like, [torch.from_numpy(ref[f"{tree}/x/{i}"])
                                 for i in range(len(tree_leaves(like)))])


@pytest.fixture(scope="module")
def port(ref):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: C.port_round(case, _x_hat(ref, case[1]), ref["keys"])
                for name, case in {**C.CASES, **C.PORT_ONLY}.items()}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", [n for n in C.CASES if n != "real"])
def test_round_matches_reference(ref, port, name):
    got, m = port[name]
    want = ref[f"{name}/x_new"]
    close = np.isclose(got, want, rtol=1e-6, atol=1e-6)
    assert int((~close).sum()) <= got.size // 10**4, \
        (int((~close).sum()), float(np.abs(got - want).max()))
    np.testing.assert_allclose(m["delta_norm"], ref[f"{name}/m/delta_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(m["loss"], ref[f"{name}/m/loss"], rtol=1e-6)
    assert ("elias_bits" in m) == (f"{name}/m/elias_bits" in ref)
    if "elias_bits" in m:
        assert int(m["elias_bits"]) == int(ref[f"{name}/m/elias_bits"])


def test_real_loss_round_matches_reference(ref, port):
    """qwen3-smoke, exact workers and server (s0 = sn = None), f32 wire:
    the update within the bf16 view's rounding of the reference's."""
    got, m = port["real"]
    x0 = np.concatenate([ref[f"qwen/x/{i}"].reshape(-1)
                         for i in range(13)])
    d_got, d_ref = got - x0, ref["real/x_new"] - x0
    assert np.linalg.norm(d_got - d_ref) <= 5e-2 * np.linalg.norm(d_ref)
    assert abs(float(m["loss"]) - float(ref["real/m/loss"])) <= 1e-3
    np.testing.assert_allclose(m["delta_norm"], ref["real/m/delta_norm"],
                               rtol=5e-2)


@pytest.mark.parametrize("a,b", C.SAME_BITS)
def test_wires_give_the_f32_bits(port, a, b):
    assert np.array_equal(port[a][0].view(np.uint32),
                          port[b][0].view(np.uint32))
    np.testing.assert_array_equal(port[a][1]["delta_norm"],
                                  port[b][1]["delta_norm"])


# ---------------------------------------------------------------------------
# DistTransport over gloo
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """One spawn of two gloo ranks running every DIST_CASES round."""
    d = tmp_path_factory.mktemp("gloo")
    port_ = _free_port()
    env = {**_env(), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_fed_cases", "rank", str(r),
         str(port_), str(d / f"rank{r}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(C.FL)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(C.FL)]


def test_local_transport_and_its_size():
    """LocalTransport holds every worker; a round refuses a transport of
    another size than its config."""
    t = LocalTransport(3)
    assert t.workers == (0, 1, 2)
    parts = [torch.full((3, 2), float(i)) for i in range(3)]
    assert torch.equal(t.gather([p[0] for p in parts]),
                       torch.tensor([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]))
    assert [s.tolist() for s in t.reduce_scatter(parts)] == [[3.0, 3.0]] * 3
    with pytest.raises(ValueError):
        LocalTransport(0)
    fed = FedConfig(n_workers=2, Kn=(1, 1), s0=16, sn=16)
    with pytest.raises(ValueError, match="transport carries 3"):
        PR.make_round_fn(None, None, fed, t)


@pytest.mark.parametrize("name", sorted(C.DIST_CASES))
def test_dist_transport_matches_local(gloo, name):
    keys = np.arange(2 * (C.FL + 1), dtype=np.uint32).reshape(C.FL + 1, 2)
    want, wm = C.port_round(C.DIST_CASES[name], C.stub_params(), keys,
                            LocalTransport(C.FL))
    for r in range(C.FL):
        got = gloo[r][f"{name}/x_new"]
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), r
        for k, v in wm.items():
            np.testing.assert_array_equal(gloo[r][f"{name}/m/{k}"], v)
