"""The rotated codec's pieces and the one-pass payload encode against the
JAX package on the CPU: the rotation (bitwise), the int4 nibble pack, the
plain versions of the fused kernels K4/K5, and
``Codec.encode_payload``/``decode_payload``.

Inputs come from numpy with fixed seeds and go to both packages.  The CUDA
kernels run only on the card: ``chip_smoke.py`` holds each one against the
plain version tested here."""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import backends as RB
from repro.compress import codec as RC
from repro.compress import rotation as RR
from repro.compress import wire as RW
from repro_torch.compress import backends as PB
from repro_torch.compress import codec as PC
from repro_torch.compress import rotation as PR
from repro_torch.compress import wire as PW
from repro_torch.kernels import build
from repro_torch.kernels import fused_encode as FE
from repro_torch.kernels import qsgd as K

SEEDS = [0, 5, 2**32 - 1]


def _draw(n, seed, m=None):
    """y (n,) and u (m or n,) f32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(n) * 3).astype(np.float32)
    return y, rng.random(n if m is None else m, dtype=np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# The JAX package's functions jitted, as its runtime runs them: one small
# program per shape instead of one per primitive when called eagerly.
_j_pack = jax.jit(RW.pack_int4)
_j_unpack = jax.jit(RW.unpack_int4, static_argnums=1)
_j_encode_fused = jax.jit(RB.encode_fused_jnp, static_argnums=1,
                          static_argnames="pack")


@functools.partial(jax.jit, static_argnums=(1, 3))
def _j_encode_pack(r, s, u, pack):
    """encode_jnp of a rotated message, int8 levels (+ pack_int4)."""
    lvl, norm = RB.encode_jnp(r, s, u)
    lvl = lvl.astype(jnp.int8)
    return (RW.pack_int4(lvl) if pack else lvl), norm


@functools.lru_cache(maxsize=None)
def _jax_rotations(n):
    """The JAX package's rotate and unrotate of one message of length n
    under every seed, one jit each per length (as its runtime runs them;
    bitwise the eager results, at a fraction of the compile time).
    (Not one program for both: XLA would then simplify across the two,
    factoring the rotation's scale out of the unrotation's first adds.)"""
    y, _ = _draw(n, seed=n)
    rs = jax.jit(lambda v: [RR.rotate(v, s) for s in SEEDS])(jnp.asarray(y))
    backs = jax.jit(lambda rs: [RR.unrotate(r, s, n)
                                for r, s in zip(rs, SEEDS)])(rs)
    return y, {s: (np.asarray(r), np.asarray(b))
               for s, r, b in zip(SEEDS, rs, backs)}


@pytest.mark.parametrize("n", [1, 2, 1000, 2**15, 2**15 + 1, 101770])
@pytest.mark.parametrize("seed", SEEDS)
def test_rotation_bitwise(n, seed):
    """rademacher, rotate and unrotate give the JAX package's bits: the
    uint32 hash in masked int64, the same butterfly order, the same f32
    scale."""
    y, ref = _jax_rotations(n)
    r_j, back_j = ref[seed]
    d = PR.next_pow2(n)
    assert d == RR.next_pow2(n)
    np.testing.assert_array_equal(PR.rademacher(d, seed, device="cpu").numpy(),
                                  np.asarray(RR.rademacher(d, seed)))
    r_p = PR.rotate(torch.from_numpy(y), seed)
    assert r_p.shape == (d,)
    np.testing.assert_array_equal(_bits(r_p.numpy()), _bits(r_j))
    np.testing.assert_array_equal(
        _bits(PR.unrotate(r_p, seed, n).numpy()), _bits(back_j))


def test_rademacher_defaults_to_the_card():
    """``rademacher`` runs on the card unless asked for the CPU: with no
    card a call without a device raises, with one the signs lie there."""
    assert PR.rademacher(8, 5, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert PR.rademacher(8, 5).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PR.rademacher(8, 5)


def _k5_split(x, order="kernel"):
    """K5's data split on the CPU (``csrc/fused_encode.cu``): the message
    of d coordinates in c = k5_cluster(d) chunks of m, a block's; in a
    chunk, e = min(16, m) contiguous coordinates a thread, the stages
    h < e in its registers, then h = e, 2e, ... < m across its threads
    (warp shuffles, then shared memory); then the gather of column j over
    the chunks, x[k * m + j] for k < c, and the cross stages h = m, 2m, 4m
    on it.  ``order="cross-first"`` runs the cross stages before the
    chunks' own: the same butterflies in another order."""
    d = x.shape[-1]
    c = FE.k5_cluster(d)
    m = d // c
    e = min(16, m)

    def local(t):
        t = PR.fwht(t.reshape(c, m // e, e))                  # h < e
        return PR.fwht(t.transpose(1, 2)).transpose(1, 2).reshape(c, m)

    def cross(t):
        return PR.fwht(t.reshape(c, m).t()).t()               # h >= m

    t = cross(local(x)) if order == "kernel" else local(cross(x))
    return t.reshape(d)


@pytest.mark.parametrize("d", [2**k for k in range(1, 16)])
@pytest.mark.parametrize("seed", SEEDS)
def test_k5_split_is_the_plain_rotation(d, seed):
    """The kernel's split of the butterflies over registers, lanes, warps
    and the blocks of a cluster gives the plain rotation bit for bit,
    because it runs the stages in the plain FWHT's order h = 1, 2, 4, ...;
    where the message spans several blocks, the same butterflies with the
    cross-block stages first give other bits: the stage order, not the
    layout, is what keeps K5 bitwise."""
    y, _ = _draw(d, seed=d + 7)
    yt = torch.from_numpy(y)
    signed = yt * PR.rademacher(d, seed, device="cpu")
    scale = float(np.float32(d ** -0.5))
    want = PR.rotate(yt, seed)
    got = _k5_split(signed) * scale
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    if FE.k5_cluster(d) > 1:
        other = _k5_split(signed, order="cross-first") * scale
        assert not np.array_equal(_bits(other.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("d", [2**k for k in range(1, 16)])
def test_k5_cluster_size(d):
    """K5's cluster size is a function of d alone that divides d, at most
    the portable 8 blocks; each block's chunk fits the 227 KiB a block may
    have (16 KiB at most), and csrc/fused_encode.cu instantiates the
    kernel for that (chunk, cluster) pair."""
    c = FE.k5_cluster(d)
    assert c == FE.k5_cluster(d) and 1 <= c <= 8 and d % c == 0
    assert d // c <= FE.K5_CHUNK and 4 * (d // c) <= 227 * 1024
    with open(f"{build.CSRC_DIR}/fused_encode.cu") as f:
        cases = {(int(a), int(b)) for a, b in
                 re.findall(r"K5_CASE\((\d+), (\d+)\)", f.read())}
    assert (d // c, c) in cases
    assert FE._k5_args(torch.zeros(2, d), 5, 7, True)[:3] == (2, d, c)


def test_rotation_batches_rows():
    """The N worker messages rotate as one (N, d) tensor, row for row."""
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((3, 1000)).astype(np.float32))
    r = PR.rotate(y, 5)
    assert r.shape == (3, 1024)
    for i in range(3):
        assert torch.equal(r[i], PR.rotate(y[i], 5))
    assert torch.equal(PR.unrotate(r, 5, 1000)[2], PR.unrotate(r[2], 5, 1000))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1001])
def test_pack_int4_equal(n):
    """Lo nibble first, an odd tail's high nibble 0, nibbles above 7 sign-
    extended on unpack; the extremes +-7 included."""
    lvl = np.random.default_rng(n).integers(-7, 8, n).astype(np.int8)
    lvl[:2] = [-7, 7][:min(n, 2)]
    p_j = np.asarray(_j_pack(jnp.asarray(lvl)))
    p_p = PW.pack_int4(torch.from_numpy(lvl))
    assert p_p.dtype == torch.int8 and p_p.shape == ((n + 1) // 2,)
    np.testing.assert_array_equal(p_p.numpy(), p_j)
    back = PW.unpack_int4(p_p, n)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(_j_unpack(jnp.asarray(p_j), n)))
    np.testing.assert_array_equal(back.numpy(), lvl)


def _payload_given_norm(y, u, s, norm, pack):
    """The plain quantize (+ pack) fed one given norm per row."""
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    inv = torch.full_like(safe, float(s)) / safe
    lvl = K.quantize_plain(y, u, inv, s)
    return PW.pack_int4(lvl) if pack else lvl


@pytest.mark.parametrize("n", [1, 2, 2049, 2**16 + 3])
@pytest.mark.parametrize("pack", [True, False])
def test_fused_encode_plain_vs_encode_fused_jnp(n, pack):
    """K4's plain version: the norm within rtol 1e-6 of the reference
    one-pass encode's, and, fed that norm, the same payload bytes."""
    s = 7 if pack else 127
    y, u = _draw(n, seed=n + s)
    pay_j, norm_j = _j_encode_fused(jnp.asarray(y), s, jnp.asarray(u),
                                    pack=pack)
    yt, ut = torch.from_numpy(y)[None], torch.from_numpy(u)[None]
    pay_p, norm_p = FE.fused_encode_plain(yt, ut, s, pack)
    assert pay_p.dtype == torch.int8
    assert pay_p.shape == (1, (n + 1) // 2 if pack else n)
    np.testing.assert_allclose(float(norm_p[0]), float(norm_j), rtol=1e-6)
    given = _payload_given_norm(yt, ut, s, torch.tensor([float(norm_j)]),
                                pack)
    np.testing.assert_array_equal(given[0].numpy(), np.asarray(pay_j))


@pytest.mark.parametrize("n", [2, 64, 1000, 2**15])
@pytest.mark.parametrize("pack", [True, False])
def test_fused_rotate_plain_vs_rotate_encode_jnp(n, pack):
    """K5's plain version against rotate + encode_jnp (+ pack_int4): the
    rotated rows bitwise, the norm within rtol 1e-6, the payload equal
    given the reference's norm."""
    s, seed = (7, 5) if pack else (127, 2**32 - 1)
    d = PR.next_pow2(n)
    y, u = _draw(n, seed=n, m=d)
    r_j = _jax_rotations(n)[1][seed][0]          # the rotation of this y
    pay_j, norm_j = _j_encode_pack(jnp.asarray(r_j), s, jnp.asarray(u), pack)
    pay_j = np.asarray(pay_j)
    ypad = torch.nn.functional.pad(torch.from_numpy(y), (0, d - n))[None]
    ut = torch.from_numpy(u)[None]
    pay_p, norm_p = FE.fused_rotate_encode_plain(ypad, ut, s, seed, pack)
    r_p = PR.rotate(ypad, seed)
    np.testing.assert_array_equal(_bits(r_p[0].numpy()), _bits(r_j))
    np.testing.assert_allclose(float(norm_p[0]), float(norm_j), rtol=1e-6)
    given = _payload_given_norm(r_p, ut, s, torch.tensor([float(norm_j)]),
                                pack)
    np.testing.assert_array_equal(given[0].numpy(), pay_j)


@pytest.mark.parametrize("pack", [True, False])
def test_plain_versions_vs_pallas_interpret(pack):
    """The Pallas kernels themselves (interpret mode, small n): K4 at
    n = 2049 and K5 at n = 1000 (d = 1024); norms within rtol 1e-6 and the
    payload equal given the kernel's norm."""
    s = 7 if pack else 127
    y, u = _draw(2049, seed=3)
    pay_k, norm_k = RB.encode_fused(jnp.asarray(y), s, jnp.asarray(u),
                                    pack=pack, interpret=True)
    yt, ut = torch.from_numpy(y)[None], torch.from_numpy(u)[None]
    _, norm_p = FE.fused_encode_plain(yt, ut, s, pack)
    np.testing.assert_allclose(float(norm_p[0]), float(norm_k), rtol=1e-6)
    np.testing.assert_array_equal(
        _payload_given_norm(yt, ut, s, torch.tensor([float(norm_k)]),
                            pack)[0].numpy(), np.asarray(pay_k))

    y, u = _draw(1000, seed=4, m=1024)
    pay_k, norm_k = RB.encode_rotated_fused(jnp.asarray(y), s, jnp.asarray(u),
                                            5, pack=pack, interpret=True)
    ypad = torch.nn.functional.pad(torch.from_numpy(y), (0, 24))[None]
    ut = torch.from_numpy(u)[None]
    _, norm_p = FE.fused_rotate_encode_plain(ypad, ut, s, 5, pack)
    r_p = PR.rotate(ypad, 5)
    np.testing.assert_allclose(float(norm_p[0]), float(norm_k), rtol=1e-6)
    np.testing.assert_array_equal(
        _payload_given_norm(r_p, ut, s, torch.tensor([float(norm_k)]),
                            pack)[0].numpy(), np.asarray(pay_k))


@pytest.mark.parametrize("kind", ["qsgd", "rotated"])
@pytest.mark.parametrize("wire,s", [("int4", 7), ("int8", 127),
                                    ("packed", 16384)])
def test_payload_entry_points_vs_jnp(kind, wire, s, n=1001):
    """encode_payload / decode_payload of the reference backend against the
    JAX package's jnp backend, on an odd length (padded to 1,024 by the
    rotated codec): equal nbits and payload shape, the same
    payload where the norms agree bit for bit, and the decoded message
    within rtol 1e-6 (the norms' summation orders differ).  The kernel
    backend (plain versions on the CPU) decodes to the same message up to
    the documented ulp flips of its |y| * (s / norm) order."""
    rc = RC.make_codec(s, wire=wire, kind=kind, seed=5)
    pc = PC.make_codec(s, wire=wire, kind=kind, seed=5)
    m = pc.padded_dim(n)
    y, u = _draw(n, seed=n + s, m=m)
    pay_j, norm_j, bits_j = jax.jit(rc.encode_payload)(jnp.asarray(y),
                                                       jnp.asarray(u))
    pay_p, norm_p, bits_p = pc.encode_payload(torch.from_numpy(y),
                                              torch.from_numpy(u))
    assert bits_p == bits_j
    assert bits_p == (8 * ((m + 1) // 2) if wire == "int4"
                      else int(PW.level_bits(s, wire)) * m)
    assert tuple(pay_p.shape) == tuple(np.shape(pay_j))
    np.testing.assert_allclose(float(norm_p), float(norm_j), rtol=1e-6)
    if float(norm_p) == float(norm_j):
        np.testing.assert_array_equal(pay_p.numpy(), np.asarray(pay_j))
    dec_j = np.asarray(jax.jit(rc.decode_payload, static_argnums=2)(
        pay_j, norm_j, m))
    dec_p = pc.decode_payload(pay_p, norm_p, m)
    assert dec_p.shape == (m,)
    # the unrotation's butterflies add rounding of the order of the
    # message's largest value, not of each coordinate
    np.testing.assert_allclose(dec_p.numpy(), dec_j, rtol=1e-6,
                               atol=1e-6 * np.abs(dec_j).max())
    kc = PC.make_codec(s, wire=wire, kind=kind, seed=5, backend="cuda")
    pay_k, norm_k, bits_k = kc.encode_payload(torch.from_numpy(y),
                                              torch.from_numpy(u))
    assert bits_k == bits_p and pay_k.shape == pay_p.shape
    if wire == "int4":
        lvl_k, lvl_p = PW.unpack_int4(pay_k, m), PW.unpack_int4(pay_p, m)
    else:
        lvl_k, lvl_p = pay_k, pay_p
    flips = (lvl_k.to(torch.int32) - lvl_p.to(torch.int32)).abs()
    assert flips.max() <= 1 and (flips > 0).float().mean() <= 1e-3
    torch.testing.assert_close(kc.decode(lvl_p, norm_k),
                               pc.decode(lvl_p, norm_p), rtol=1e-6,
                               atol=1e-6 * float(dec_p.abs().max()))


def test_rotated_payload_above_fused_limit():
    """n = 2^15 + 1 pads to 2^16, past K5's one-block limit: the rotated
    int4 payload takes the reference's fallback, rotate + K4, under the
    same checks as above."""
    test_payload_entry_points_vs_jnp("rotated", "int4", 7, n=2**15 + 1)


@pytest.mark.parametrize("s", [None, 1, 7, 127, 16384])
@pytest.mark.parametrize("wire", ["packed", "int8", "int4", "f32"])
@pytest.mark.parametrize("dim", [1000, 101770])
def test_rotated_pricing_equal(s, wire, dim):
    """M_s and q_s of the rotated codec: the padded levels plus the 32-bit
    seed, Assumption 1 at the padded dimension — equal to the JAX
    package's, including the (s, wire) pairs it refuses."""
    try:
        rc = RC.make_codec(s, wire=wire, kind="rotated")
        want = (rc.wire_bits(dim), rc.variance_bound(dim))
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            PC.make_codec(s, wire=wire, kind="rotated").wire_bits(dim)
        return
    pc = PC.make_codec(s, wire=wire, kind="rotated")
    assert type(pc).__name__ == type(rc).__name__
    assert (pc.wire_bits(dim), pc.variance_bound(dim)) == want


def test_rotated_codec_paper_s_vs_jnp():
    """At the runtime's s = 2^14 the rotated codec's int32 levels agree
    with the JAX package's up to the ulp flips of the kernel order (the
    reference backend) — both backends, one batched (N, d') encode."""
    s, n = 2**14, 5000
    rng = np.random.default_rng(9)
    y = (rng.standard_normal((3, n)) * 3).astype(np.float32)
    u = rng.random((3, 8192), dtype=np.float32)
    enc = jax.jit(RC.make_codec(s, kind="rotated", seed=5).encode)
    ref = [enc(jnp.asarray(y[i]), jnp.asarray(u[i])) for i in range(3)]
    lvl_j = np.stack([np.asarray(r[0]) for r in ref]).astype(np.int32)
    for backend in ("torch", "cuda"):
        codec = PC.make_codec(s, kind="rotated", seed=5, backend=backend)
        lvl, norm = codec.encode(torch.from_numpy(y), torch.from_numpy(u))
        assert lvl.dtype == torch.int32 and lvl.shape == (3, 8192)
        np.testing.assert_allclose(norm.numpy(), [float(r[1]) for r in ref],
                                   rtol=1e-6)
        diff = np.abs(lvl.numpy() - lvl_j)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
        out = codec.quantize_dequantize(torch.from_numpy(y),
                                        torch.from_numpy(u))
        assert out.shape == (3, n)


def test_fused_wrappers_refuse_bad_inputs():
    """d outside the kernel's shared-memory block, a row that is not a
    power of two, mismatched shapes or devices: ValueError, no launch."""
    z = torch.zeros(1, 2**16)
    with pytest.raises(ValueError, match="power-of-two"):
        FE.fused_rotate_encode(z, z, 7, 0, pack=True)
    with pytest.raises(ValueError, match="power-of-two"):
        FE.fused_rotate_encode(torch.zeros(1, 6), torch.zeros(1, 6), 7, 0)
    with pytest.raises(ValueError, match="power-of-two"):
        PB.encode_rotated_fused(torch.zeros(1), 7, torch.zeros(1), 0)
    with pytest.raises(ValueError):
        FE.fused_encode(torch.zeros(2, 8), torch.zeros(2, 9), 7)
    with pytest.raises(ValueError):
        FE.fused_encode(torch.zeros(2, 8, device="meta"),
                        torch.zeros(2, 8, device="meta"), 7)
    assert FE.LAUNCHES == dict.fromkeys(FE.LAUNCHES, 0)


def test_fused_ctypes_signatures_match_the_cuda_source():
    """Each C entry point's parameter count in csrc/fused_encode.cu equals
    the wrapper's ctypes argtypes plus the stream."""
    with open(f"{build.CSRC_DIR}/fused_encode.cu") as f:
        src = f.read()
    ext = src[src.index('extern "C" {'):]
    found = dict((m.group(1), len(m.group(2).split(",")))
                 for m in re.finditer(r"int (fused_\w+)\(([^)]*)\)", ext))
    assert set(found) == set(FE._SIGS)
    for name, n in found.items():
        assert n == len(FE._SIGS[name]) + 1, name
