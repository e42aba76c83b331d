"""Per-bucket norms (QSGD bucketing) in the port against the JAX package:
bucketed levels and norms, the functional API, K3b's plain version, the
bucketed payloads, a bucketed round with injected draws, pricing and
Plans.  Inputs come from numpy with fixed seeds and go to both packages;
the CUDA kernels (K1/K2 over bucket rows, K3b, K4 over bucket rows) run
only on the card, where ``chip_smoke.py`` holds each against the plain
version tested here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as RC
from repro.api import EdgeSystem as REdge
from repro.api import MNISTTask as RTask
from repro.api import Plan as RPlan
from repro.api import Scenario as RScenario
from repro.compress import wire as RW
from repro.core.convergence import MLProblemConstants as RConsts
from repro.core.genqsgd import GenQSGD as RGenQSGD
from repro.core.genqsgd import flatten_like as r_flatten
from repro.core.step_rules import ConstantRule as RConstant
from repro_torch import compress as PC
from repro_torch.api import EdgeSystem, MNISTTask, Plan, Scenario
from repro_torch.compress import backends as B
from repro_torch.core.convergence import MLProblemConstants
from repro_torch.core.genqsgd import GenQSGD, flatten_like
from repro_torch.core.step_rules import ConstantRule
from repro_torch.kernels import qsgd as K
from repro_torch.models.mlp import params_from_jax
from tests.test_torch_slice import CONSTS, GAMMA, QUICK, S, _equal_plans, \
    _jax_draws

N = 10
BUCKETS = [16, 64, 1000, 4095, 4096, 1 << 20]


def _draw(shape, seed, zero_bucket=None):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(shape) * 3).astype(np.float32)
    if zero_bucket is not None:
        q, b = zero_bucket
        y[..., b * q:(b + 1) * q] = 0.0
    return y, rng.random(shape, dtype=np.float32)


def _rows(a):
    return a.reshape(-1, a.shape[-1])


def _ref_encode(y, u, s, q):
    """The JAX package's bucketed encode of each row alone."""
    out = [RC.make_codec(s, bucket=q).encode(jnp.asarray(yr), jnp.asarray(ur))
           for yr, ur in zip(_rows(y), _rows(u))]
    return (np.stack([np.asarray(lv) for lv, _ in out]),
            np.stack([np.asarray(nm) for _, nm in out]))


@pytest.mark.parametrize("shape", [(5000,), (3, 4100)], ids=["1d", "rows"])
@pytest.mark.parametrize("bucket", BUCKETS)
def test_bucketed_levels_match_reference(bucket, shape):
    """Levels bitwise the JAX package's given the same u, on both
    backends (the kernel backend's plain versions here), norms (..., n /
    bucket rounded up) within rtol 1e-6; given the reference's norms the
    level assignment is bitwise whatever the norm's summation order."""
    s = 127
    y, u = _draw(shape, seed=bucket % 997 + len(shape))
    lvl_r, norm_r = _ref_encode(y, u, s, bucket)
    nb = -(-shape[-1] // bucket)
    for backend in ("torch", "cuda"):
        lvl, norm = PC.make_codec(s, bucket=bucket, backend=backend).encode(
            torch.from_numpy(y), torch.from_numpy(u))
        assert lvl.shape == shape and norm.shape == (*shape[:-1], nb)
        assert lvl.dtype == torch.int8
        np.testing.assert_allclose(_rows(norm.numpy()), norm_r, rtol=1e-6)
        np.testing.assert_array_equal(_rows(lvl.numpy()), lvl_r)
    yb, ub = (B.to_buckets(torch.from_numpy(_rows(a)), bucket)
              for a in (y, u))
    lvl_g = B.qsgd_levels(yb, ub, s, torch.from_numpy(norm_r)[..., None])
    np.testing.assert_array_equal(
        lvl_g.reshape(len(lvl_r), -1)[:, :shape[-1]].numpy(), lvl_r)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_bucket_of_zeros(backend):
    """A bucket of all zeros has norm 0 and levels 0 and decodes to 0, as
    in the JAX package; its neighbours are untouched."""
    q, s = 64, 7
    y, u = _draw((1000,), seed=4, zero_bucket=(q, 3))
    codec = PC.make_codec(s, bucket=q, backend=backend)
    lvl, norm = codec.encode(torch.from_numpy(y), torch.from_numpy(u))
    lvl_r, norm_r = _ref_encode(y, u, s, q)
    assert float(norm[3]) == 0.0 == float(norm_r[0, 3])
    assert not lvl[3 * q:4 * q].any()
    np.testing.assert_array_equal(lvl.numpy(), lvl_r[0])
    dec = codec.decode(lvl, norm)
    assert not dec[3 * q:4 * q].any()
    ref = RC.make_codec(s, bucket=q).decode(jnp.asarray(lvl_r[0]),
                                            jnp.asarray(norm_r[0]))
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("bucket", [16, 64, 1000])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_encode_tensor_bucketed_matches_codec(bucket, backend):
    """``encode_tensor`` / ``decode_tensor`` compute what the codec does,
    and what the JAX package's functional API gives."""
    y, u = _draw((37 * 11,), seed=bucket)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    codec = PC.make_codec(7, bucket=bucket, backend=backend)
    lvl_c, nrm_c = codec.encode(yt, ut)
    lvl_f, nrm_f = PC.encode_tensor(yt, 7, ut, backend=backend,
                                    bucket=bucket)
    assert lvl_f.dtype == torch.int8
    assert torch.equal(lvl_f, lvl_c) and torch.equal(nrm_f, nrm_c)
    d_f = PC.decode_tensor(lvl_f, nrm_f, 7, bucket=bucket)
    assert torch.equal(d_f, codec.decode(lvl_c, nrm_c))
    lvl_r, nrm_r = RC.encode_tensor(jnp.asarray(y), 7, jnp.asarray(u),
                                    bucket=bucket)
    np.testing.assert_array_equal(lvl_f.numpy(), np.asarray(lvl_r))
    np.testing.assert_allclose(nrm_f.numpy(), np.asarray(nrm_r), rtol=1e-6)
    np.testing.assert_allclose(
        d_f.numpy(), np.asarray(RC.decode_tensor(lvl_r, nrm_r, 7,
                                                 bucket=bucket)),
        rtol=1e-6, atol=1e-7)


def test_encode_tensor_passthrough_and_container():
    """s = None passes the tensor through with a unit norm; the int8
    container refuses s > 127, as the JAX package's does."""
    y = torch.randn(10)
    lvl, norm = PC.encode_tensor(y, None, y)
    assert lvl is y and float(norm) == 1.0
    assert PC.decode_tensor(y, norm, None) is not None
    for mod in (PC, RC):
        with pytest.raises(ValueError, match="127"):
            mod.encode_tensor(y if mod is PC else jnp.zeros(10), 128,
                              y if mod is PC else jnp.zeros(10))


# ---------------------------------------------------------------------------
# K3b's plain version and its thread map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q", [1, 3, 8, 4095, 4096, 101770, 1 << 20])
def test_dequant_apply_bucketed_plain(q):
    """K3b's plain version is x + (gamma * lvl) * (norm[i // q] / s) in
    float32, each product and the sum rounded once (numpy's float32 is the
    oracle); at q >= n it is K3's plain version bit for bit."""
    n, s, gamma = 101770, 16384, np.float32(0.0123)
    rng = np.random.default_rng(q % 1009)
    x = rng.standard_normal(n).astype(np.float32)
    lvl = rng.integers(-s, s + 1, n).astype(np.int32)
    norms = (rng.random(-(-n // q)) * 5).astype(np.float32)
    out = K.dequant_apply_bucketed_plain(
        torch.from_numpy(x), torch.from_numpy(lvl), torch.from_numpy(norms),
        s, float(gamma), q)
    scale = norms / np.float32(s)
    want = x + (gamma * lvl.astype(np.float32)) * scale[np.arange(n) // q]
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))
    if q >= n:
        k3 = K.dequant_apply_plain(torch.from_numpy(x), torch.from_numpy(lvl),
                                   torch.from_numpy(norms), s, float(gamma))
        assert torch.equal(out.view(torch.int32), k3.view(torch.int32))
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(out, K.qsgd_dequant_apply_bucketed(
        torch.from_numpy(x), torch.from_numpy(lvl), torch.from_numpy(norms),
        s, float(gamma), q))


def _k3b_buckets(n, q, head, stride, vec):
    """The bucket K3b's thread map (csrc/qsgd.cu: BucketWalk,
    bucket_scales) gives each element, for ``stride`` threads."""
    got = np.full(n, -1, np.int64)

    def item(e, b, r, m):
        for k in range(min(4, m)):
            bk, rk = b, r + k
            while rk >= q:
                rk -= q
                bk += 1
            if r + 3 < q:
                assert bk == b
            got[e + k] = bk

    for tid in range(stride):
        e0 = (head + 4 * tid) if vec else 4 * tid
        b, r = e0 // q, e0 % q
        db, dr = (4 * stride) // q, (4 * stride) % q
        if vec:
            nvec = (n - head) >> 2
            i = tid
            while i < nvec:
                item(head + 4 * i, b, r, 4)
                i += stride
                b, r = b + db, r + dr
                if r >= q:
                    r, b = r - q, b + 1
            tail = (nvec << 2) + tid if tid - head < ((n - head) & 3) else -1
            end = tid if tid < head else tail
            if end >= 0:
                got[end] = end // q
        else:
            i = e0
            while i < n:
                item(i, b, r, n - i)
                i += 4 * stride
                b, r = b + db, r + dr
                if r >= q:
                    r, b = r - q, b + 1
    return got


@pytest.mark.parametrize("q", [1, 3, 5, 8, 13, 64])
@pytest.mark.parametrize("head", [0, 1, 3])
def test_k3b_thread_map_buckets(q, head):
    """Every element gets bucket i // q under K3b's division-free walk, on
    both branches, whatever the head peel and however items straddle
    bucket edges (a grid smaller than the message, so the walk steps)."""
    n = 517
    for vec in (True, False):
        got = _k3b_buckets(n, q, head, 24, vec)
        np.testing.assert_array_equal(got, np.arange(n) // q)


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bucket", [64, 65, 4095, 4096])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_bucketed_int4_payload_matches_reference(bucket, backend):
    """The bucketed int4 payload is the JAX package's flat pack byte for
    byte, for an even bucket (K4's packed rows end to end) and an odd one
    (a byte straddles two buckets), on an odd-length message; and it
    decodes to ``decode(*encode)``."""
    n = 10001
    y, u = _draw((n,), seed=bucket)
    codec = PC.make_codec(7, wire="int4", bucket=bucket, backend=backend)
    payload, norm, nbits = codec.encode_payload(torch.from_numpy(y),
                                                torch.from_numpy(u))
    rp, rn, rbits = RC.make_codec(7, wire="int4", bucket=bucket) \
        .encode_payload(jnp.asarray(y), jnp.asarray(u))
    assert payload.shape == ((n + 1) // 2,) and nbits == int(rbits)
    np.testing.assert_array_equal(payload.numpy(), np.asarray(rp))
    np.testing.assert_allclose(norm.numpy(), np.asarray(rn), rtol=1e-6)
    dec = codec.decode_payload(payload, norm, n)
    assert torch.equal(dec, codec.decode(*codec.encode(torch.from_numpy(y),
                                                       torch.from_numpy(u))))
    # batched rows: each row is the 1-D call's payload
    y2, u2 = _draw((3, n), seed=bucket + 1)
    p2, n2, _ = codec.encode_payload(torch.from_numpy(y2),
                                     torch.from_numpy(u2))
    for r in range(3):
        p1, n1, _ = codec.encode_payload(torch.from_numpy(y2[r]),
                                         torch.from_numpy(u2[r]))
        assert torch.equal(p2[r], p1) and torch.equal(n2[r], n1)


@pytest.mark.parametrize("wire,s", [("int8", 127), ("packed", 300)])
def test_bucketed_level_payload_matches_reference(wire, s):
    n, q = 10001, 4096
    y, u = _draw((n,), seed=s)
    codec = PC.make_codec(s, wire=wire, bucket=q, backend="cuda")
    payload, norm, nbits = codec.encode_payload(torch.from_numpy(y),
                                                torch.from_numpy(u))
    rp, rn, rbits = RC.make_codec(s, wire=wire, bucket=q).encode_payload(
        jnp.asarray(y), jnp.asarray(u))
    np.testing.assert_array_equal(payload.numpy(), np.asarray(rp))
    assert nbits == int(rbits) and norm.shape == (3,)
    np.testing.assert_allclose(
        codec.decode_payload(payload, norm, n).numpy(),
        np.asarray(RC.make_codec(s, wire=wire, bucket=q).decode_payload(
            rp, rn, n)), rtol=1e-6, atol=1e-7)


def test_rotated_codec_refuses_buckets():
    for mod in (PC, RC):
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.make_codec(7, bucket=4096, kind="rotated")


# ---------------------------------------------------------------------------
# the bucketed round, pricing and Plans
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tasks():
    return RTask(), MNISTTask(device="cpu")


@pytest.mark.parametrize("bucket", [8, 4096])
def test_bucketed_round_matches_reference(tasks, bucket):
    """One bucketed round (q_dim in the Plan) with the JAX package's draws
    injected, held as ``test_round_matches_reference`` holds the unbucketed
    one: every coordinate within two server levels of the whole delta (a
    bucket's level is no larger), at most 1e-3 of them off by more than
    1e-6."""
    rtask, ptask = tasks
    rcfg = RPlan.manual(step_rule=RConstant(GAMMA), q_dim=bucket, **QUICK) \
        .to_genqsgd_config()
    pcfg = Plan.manual(step_rule=ConstantRule(GAMMA), q_dim=bucket, **QUICK) \
        .to_genqsgd_config()
    assert rcfg.bucket == pcfg.bucket == bucket
    ralg = RGenQSGD(rtask.loss, rtask.sample, rcfg)
    palg = GenQSGD(ptask.loss, ptask.make_data(N), ptask.shapes, pcfg)
    p0 = rtask.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    x_r, m_r = ralg._round(p0, rtask.make_data(N), key, jnp.float32(GAMMA))
    x_r = np.asarray(r_flatten(x_r))
    x0 = flatten_like(params_from_jax({k: np.asarray(v)
                                       for k, v in p0.items()}, device="cpu"))
    draws = _jax_draws(key, palg.n_local, pcfg.K_max, pcfg.B, palg.dim)
    x_p, m_p = palg.round(x0, *draws, GAMMA)
    np.testing.assert_allclose(float(m_p["delta_norm"]),
                               float(m_r["delta_norm"]), rtol=1e-5)
    level = GAMMA * float(m_r["delta_norm"]) / S
    diff = np.abs(x_p.numpy() - x_r)
    assert diff.max() <= 2 * level + 1e-7, (diff.max(), level)
    assert (diff > 1e-6).mean() <= 1e-3
    np.testing.assert_allclose(float(m_p["update_norm"]),
                               float(m_r["update_norm"]), rtol=1e-3)


def test_bucket_at_least_dim_is_bitwise_whole_message(tasks):
    """bucket >= D is one bucket: the round is bucket=None's bit for bit;
    bucket 8 changes the realized quantization (the JAX package's
    identity, ``tests/unit/test_bucket_runtime.py``)."""
    ptask = tasks[1]
    data = ptask.make_data(N)
    rng = np.random.default_rng(3)
    D = 101770
    idx = torch.from_numpy(rng.integers(0, data[0].shape[1], (N, 6, 1)))
    uw = torch.from_numpy(rng.random((N, D), dtype=np.float32))
    us = torch.from_numpy(rng.random(D, dtype=np.float32))
    x0 = flatten_like(ptask.init_params(torch.Generator().manual_seed(0)))

    def one_round(bucket):
        cfg = Plan.manual(step_rule=ConstantRule(GAMMA), q_dim=bucket,
                          **QUICK).to_genqsgd_config()
        alg = GenQSGD(ptask.loss, data, ptask.shapes, cfg)
        return alg.round(x0, idx, uw, us, GAMMA)[0]

    whole = one_round(None)
    assert torch.equal(one_round(1 << 20), whole)
    assert torch.equal(one_round(D), whole)
    assert not torch.equal(one_round(8), whole)


def _system_with(mod, sn, s0, wire, dim=1000, q_dim=None):
    n = len(sn)
    return mod(F0=1e9, C0=100.0, p0=1.0, r0=1e6, s0=s0, alpha0=1e-28,
               Fn=np.full(n, 1e9), Cn=np.full(n, 1e8), pn=np.full(n, 1.0),
               rn=np.full(n, 1e6), sn=sn, alphan=np.full(n, 1e-28), dim=dim,
               q_dim=q_dim, wire=wire)


@pytest.mark.parametrize("q_dim", [128, 4096])
def test_bucketed_pricing_equals_reference(q_dim):
    """M_sn, M_s0, q_sn, q_s0 of a bucketed EdgeSystem equal the JAX
    package's and the codec's ``wire_bits`` / ``variance_bound`` (bucket
    min(q, D)), for every runtime wire and s it carries, and the packed
    pricing wire."""
    dim = 1000 if q_dim == 128 else 101770
    for wire in RW.RUNTIME_WIRES + ("packed",):
        cap = RW.wire_max_s(wire)
        for s in (None, 1, 5, 7, 64, 127, 2**14):
            if (s is not None and cap is not None and s > cap) or \
                    (s is None and wire == "int4"):
                with pytest.raises(ValueError):
                    _ = _system_with(EdgeSystem, [s, s], s, wire, dim,
                                     q_dim).M_s0
                continue
            p = _system_with(EdgeSystem, [s, s], s, wire, dim, q_dim)
            r = _system_with(REdge, [s, s], s, wire, dim, q_dim)
            codec = PC.make_codec(s, wire=wire, bucket=q_dim)
            assert p.M_s0 == r.M_s0 == codec.wire_bits(dim), (s, wire)
            np.testing.assert_array_equal(p.M_sn, r.M_sn)
            assert p.q_s0 == r.q_s0 == codec.variance_bound(dim), (s, wire)
            np.testing.assert_array_equal(p.q_sn, r.q_sn)
            if s is not None:
                assert codec.variance_bound(dim) == PC.variance_bound(
                    s, min(q_dim, dim))


def test_bucketed_plan_equals_reference():
    """A genqsgd Plan on a bucketed Sec.-VII system is the JAX package's,
    field for field, and its bits are the bucketed wire's."""
    q = 4096
    r = RScenario(dataclasses.replace(REdge.paper_sec_vii(), q_dim=q),
                  RConsts(**CONSTS), T_max=1e5, C_max=0.25,
                  step=RConstant(1e-3))
    sysp = dataclasses.replace(EdgeSystem.paper_sec_vii(), q_dim=q)
    p = Scenario(sysp, MLProblemConstants(**CONSTS), T_max=1e5, C_max=0.25,
                 step=ConstantRule(1e-3))
    rp, pp = r.optimize(), p.optimize()
    assert pp.feasible and pp.q_dim == q
    _equal_plans(rp, pp)
    assert pp.round_bits() == rp.round_bits() == \
        float(np.sum(sysp.M_sn)) + sysp.M_s0
    assert sysp.M_s0 != EdgeSystem.paper_sec_vii().M_s0


def test_plan_manual_bucketed_and_rotated_family_drops_q_dim():
    """``Plan.manual(q_dim=256)`` carries the bucket to the runtime config;
    a rotated family on a bucketed system drops q_dim (the JAX package's
    ``test_gqfedwavg_on_bucketed_system_drops_q_dim``, on paper_sec_vii
    with q_dim in place of the TPU fleet preset), and a rotated manual
    Plan with q_dim is refused."""
    p = Plan.manual(K0=10, Kn=(1, 2), B=4, step_rule=ConstantRule(0.05),
                    s0=64, sn=(16, 127), q_dim=256)
    assert p.q_dim == 256 and p.to_genqsgd_config().bucket == 256
    assert p.round_bits(dim=1000) == RPlan.manual(
        K0=10, Kn=(1, 2), B=4, step_rule=RConstant(0.05), s0=64,
        sn=(16, 127), q_dim=256).round_bits(dim=1000)
    sys_b = dataclasses.replace(EdgeSystem.paper_sec_vii(dim=1024),
                                q_dim=256)
    scn = Scenario(system=sys_b, consts=MLProblemConstants(**CONSTS),
                   T_max=1e5, C_max=0.25, family="gqfedwavg")
    assert scn._priced_system.q_dim is None
    plan = scn.optimize(max_iter=5)
    assert plan.q_dim is None and plan.codec_kind == "rotated"
    with pytest.raises(ValueError, match="mutually exclusive"):
        Plan.manual(K0=1, Kn=(1,), B=1, step_rule=ConstantRule(0.1),
                    codec_kind="rotated", q_dim=256)


def test_bucketed_scenario_runs():
    """``Scenario.run`` on a bucketed system: the comm bits of a capped
    run are rounds * (sum M_sn + M_s0) at the bucketed wire's bits, and
    the model learns a little."""
    sysp = dataclasses.replace(EdgeSystem.paper_sec_vii(), q_dim=4096)
    scn = Scenario(sysp, MLProblemConstants(**CONSTS), T_max=1e5,
                   C_max=0.25)
    plan = scn.optimize()
    assert plan.q_dim == 4096
    rep = scn.run(plan, task=MNISTTask(device="cpu"), max_rounds=3,
                  device="cpu")
    assert rep.rounds == 3 and rep.model_dim == 101770
    assert rep.comm_bits == 3 * (float(np.sum(sysp.M_sn)) + sysp.M_s0)
    assert np.isfinite(rep.final_metrics["eval_loss"])
