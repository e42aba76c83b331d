"""The port's QSGD kernels (plain versions, on the CPU) and codec pricing
against the JAX package.

Inputs come from numpy with fixed seeds and go to both packages.  The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds each one
against the plain version tested here."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import backends as RB
from repro.compress import codec as RC
from repro.compress import wire as RW
from repro.core.cost import EdgeSystem as REdge
from repro.core.cost import energy_cost as r_energy
from repro.core.cost import time_cost as r_time
from repro.kernels import qsgd as RK
from repro_torch.compress import codec as PC
from repro_torch.compress import wire as PW
from repro_torch.core.cost import EdgeSystem as PEdge
from repro_torch.core.cost import energy_cost as p_energy
from repro_torch.core.cost import time_cost as p_time
from repro_torch.kernels import build
from repro_torch.kernels import qsgd as K

SHAPES = [(127,), (3, 5, 77), (2**16 + 3,)]
S_SMALL = [1, 7, 64, 127]


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(shape) * 3).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    return y, u


def _rows(a):
    return torch.from_numpy(np.ascontiguousarray(a).reshape(1, -1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s", S_SMALL)
def test_quantize_plain_bitwise_vs_encode_jnp(shape, s):
    """K2's plain version gives the reference encode's int8 levels bit for
    bit, fed the same inv = s / norm (only the quantize is compared)."""
    y, u = _draw(shape, seed=s * 1000 + len(shape))
    lvl_j, norm_j = RB.encode_jnp(jnp.asarray(y), s, jnp.asarray(u))
    inv = np.float32(s) / np.float32(norm_j)
    lvl_p = K.quantize_plain(_rows(y), _rows(u), torch.tensor([inv]), s)
    assert lvl_p.dtype == torch.int8
    np.testing.assert_array_equal(
        lvl_p.numpy().reshape(shape), np.asarray(lvl_j).astype(np.int8))


def test_quantize_plain_bitwise_vs_pallas_interpret():
    """...and the Pallas kernel's levels, on its own padded grid."""
    s = 127
    y, u = _draw((3000,), seed=11)
    y2d, _ = RB._to_grid2d(jnp.asarray(y))
    u2d, _ = RB._to_grid2d(jnp.asarray(u))
    inv = np.float32(s) / np.float32(np.sqrt(np.sum(y * y)))
    lvl_k = RK.quantize_kernel_call(y2d, u2d, jnp.float32(inv),
                                    interpret=True)
    rows = y2d.shape[0]
    lvl_p = K.quantize_plain(torch.tensor(np.asarray(y2d)),
                             torch.tensor(np.asarray(u2d)),
                             torch.full((rows,), inv), s)
    np.testing.assert_array_equal(lvl_p.numpy(), np.asarray(lvl_k))


@pytest.mark.parametrize("shape", SHAPES)
def test_sumsq_plain_norm(shape):
    """K1's plain norm within rtol 1e-6 of the reference encode's (the
    tolerance the JAX package holds its own norm kernel to), and inv is
    s / norm in f32."""
    y, u = _draw(shape, seed=3)
    _, norm_j = RB.encode_jnp(jnp.asarray(y), 64, jnp.asarray(u))
    ss, norm, inv = K.sumsq_plain(_rows(y), 64)
    np.testing.assert_allclose(float(norm[0]), float(norm_j), rtol=1e-6)
    assert float(inv[0]) == float(np.float32(64) / np.float32(norm[0]))


def test_sumsq_zero_message_is_guarded():
    _, norm, inv = K.sumsq_plain(torch.zeros(2, 10), 7)
    assert norm.tolist() == [0.0, 0.0] and inv.tolist() == [7.0, 7.0]


@pytest.mark.parametrize("shape", [(127,), (2**16 + 3,)])
@pytest.mark.parametrize("s", [7, 127, 16384])
def test_dequant_apply_plain_vs_decode_apply(shape, s):
    """K3's plain version within rtol 1e-5 / atol 1e-6 of the reference
    codec's decode_apply (the tolerance of the JAX package's own test):
    the two group gamma * lvl * scale differently."""
    y, u = _draw(shape, seed=s)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = RC.make_codec(s)                       # jnp backend
    lvl, norm = ref.encode(jnp.asarray(y), jnp.asarray(u))
    out_j = ref.decode_apply(jnp.asarray(x), lvl, norm, 0.05)
    lvl_t = torch.tensor(np.asarray(lvl)).reshape(-1)
    out_p = K.dequant_apply_plain(torch.from_numpy(x.reshape(-1)), lvl_t,
                                  torch.tensor(float(norm)), s, 0.05)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j).reshape(-1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_paper_s_levels_vs_encode_jnp(backend):
    """At s = 2^14 (int32 levels) the norm is within rtol 1e-6 and levels
    differ by at most 1 on at most 1e-4 of the coordinates: the kernel
    order |y| * (s / norm) and the reference's (s * |y|) / norm differ by
    an ulp, which flips a level only where u falls inside it."""
    s = 2**14
    y, u = _draw((10, 101770), seed=7)
    ref = [RB.encode_jnp(jnp.asarray(y[i]), s, jnp.asarray(u[i]))
           for i in range(10)]
    codec = PC.make_codec(s, backend=backend)
    lvl, norm = codec.encode(torch.from_numpy(y), torch.from_numpy(u))
    assert lvl.dtype == torch.int32 and norm.shape == (10,)
    lvl_j = np.stack([np.asarray(r[0]) for r in ref]).astype(np.int32)
    np.testing.assert_allclose(norm.numpy(), [float(r[1]) for r in ref],
                               rtol=1e-6)
    diff = np.abs(lvl.numpy() - lvl_j)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4


def test_codec_backends_agree_and_roundtrip():
    """The reference and kernel backends of one codec give the same values
    up to the ulp-level flips above; identity passes through."""
    y, u = _draw((4, 5000), seed=5)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    a = PC.make_codec(127, backend="torch").quantize_dequantize(yt, ut)
    b = PC.make_codec(127, backend="cuda").quantize_dequantize(yt, ut)
    norm = torch.linalg.vector_norm(yt, dim=-1, keepdim=True)
    assert ((a - b).abs() <= norm / 127 * 1.0001).all()
    assert (a != b).float().mean() <= 1e-3
    assert torch.equal(PC.make_codec(None).quantize_dequantize(yt, ut), yt)


@pytest.mark.parametrize("wire", ["packed", "f32", "int8", "int4", "elias"])
@pytest.mark.parametrize("s", [None, 1, 7, 127, 16384])
def test_wire_bits_equal(wire, s):
    dim = 101770
    try:
        want = RW.wire_bits(s, dim, wire=wire)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            PW.wire_bits(s, dim, wire=wire)
        return
    assert PW.wire_bits(s, dim, wire=wire) == want
    assert PW.level_bits(s, wire) == RW.level_bits(s, wire)


@pytest.mark.parametrize("s", [None, 1, 7, 127, 16384])
@pytest.mark.parametrize("dim", [10, 101770])
def test_variance_bound_equal(s, dim):
    assert PC.variance_bound(s, dim) == RC.variance_bound(s, dim)
    assert PC.make_codec(s).variance_bound(dim) == \
        RC.make_codec(s).variance_bound(dim)
    assert PC.make_codec(s).wire_bits(dim) == RC.make_codec(s).wire_bits(dim)


@pytest.mark.parametrize("kw", [{}, {"F_ratio": 3.0, "s_ratio": 0.5},
                                {"s0": 127, "N": 4}])
def test_edge_system_costs_equal(kw):
    r, p = REdge.paper_sec_vii(**kw), PEdge.paper_sec_vii(**kw)
    for name in ("M_s0", "q_s0", "comm_time", "const_energy",
                 "server_energy"):
        assert getattr(p, name) == getattr(r, name), name
    for name in ("M_sn", "q_sn", "q_pairs", "comp_time_coeff",
                 "comp_energy_coeff", "comm_energy_coeff"):
        np.testing.assert_array_equal(getattr(p, name), getattr(r, name))
    Kn = np.arange(1, r.N + 1)
    assert p_time(p, 1234, Kn, 3) == r_time(r, 1234, Kn, 3)
    assert p_energy(p, 1234, Kn, 3) == r_energy(r, 1234, Kn, 3)


def test_wrappers_refuse_other_devices_and_types():
    """A wrapper runs the plain version only for CPU tensors; anything else
    that is not a CUDA tensor, or a wrong dtype or layout, raises."""
    y = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError):
        K.qsgd_sumsq(y, 7)
    with pytest.raises(ValueError):
        K.qsgd_sumsq(torch.zeros(2, 8, dtype=torch.float64), 7)
    with pytest.raises(ValueError):
        K.qsgd_quantize(torch.zeros(2, 8).t(), torch.zeros(8, 2),
                        torch.zeros(8), 7)
    with pytest.raises(ValueError):
        K.qsgd_dequant_apply(torch.zeros(8), torch.zeros(8, dtype=torch.int8),
                             torch.ones(1), 16384, 0.1)   # int32 container
    # a level row off x's alignment (row 1 of a (rows, 13) int32 matrix
    # starts 52 bytes in) is valid: K3 takes it on its scalar branch
    x = torch.linspace(-1, 1, 13)
    lvl = torch.arange(-19, 20, dtype=torch.int32).reshape(3, 13)
    norm = torch.tensor([2.5])
    out = K.qsgd_dequant_apply(x, lvl[1], norm, 16384, 0.1)
    assert torch.equal(out, K.dequant_apply_plain(x, lvl[1], norm, 16384, 0.1))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_aligned_copies_only_views_off_a_16_byte_boundary(offset):
    """K5's and K6's wrappers hand their kernels ``_aligned`` inputs: a
    contiguous view ``offset`` floats into its storage is copied to a
    16-byte boundary with the same values; an aligned tensor passes as
    itself."""
    base = torch.arange(40, dtype=torch.float32)
    view = base[offset:offset + 32]
    got = K._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert (got.data_ptr() == view.data_ptr()) == (view.data_ptr() % 16 == 0)


def test_ctypes_signatures_match_the_cuda_source():
    """Each C entry point's parameter count in csrc/qsgd.cu equals the
    wrapper's ctypes argtypes plus the stream."""
    with open(f"{build.CSRC_DIR}/qsgd.cu") as f:
        src = f.read()
    ext = src[src.index('extern "C" {'):]
    found = dict((m.group(1), len(m.group(2).split(",")))
                 for m in re.finditer(r"int (qsgd_\w+)\(([^)]*)\)", ext))
    assert set(found) == set(K._SIGS)
    for name, n in found.items():
        assert n == len(K._SIGS[name]) + 1, name
