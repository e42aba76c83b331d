"""Flash decode (K6): the port's plain version, which its wrapper runs for
CPU tensors, against the JAX package's Pallas kernel in interpret mode (as
``tests/kernels/test_flash_decode.py`` runs it) and against a float64
oracle where the Pallas kernel cannot go (C not a multiple of 512).

Tolerances, by q's (the output's) type: f32 1e-5 (absolute and relative:
both sides accumulate in f32, in another order), also over a bf16 cache;
bf16 3e-2, the JAX package's own for its kernel (the output is rounded to
bf16).  Inputs come from numpy seeds; bf16 inputs are the same bf16 values
on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import BLOCK_C, flash_decode_call
from repro_torch.kernels.flash_decode import (
    HEAD_DIMS, SPLITS, flash_decode, flash_decode_plain, split_ranges,
    stage_positions)

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _inputs(B, KV, G, dh, C, dtype, seed, kv_dtype=None, p_valid=0.7):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, dh)) * 2)
    k = torch.from_numpy(rng.standard_normal((B, C, KV, dh)))
    v = torch.from_numpy(rng.standard_normal((B, C, KV, dh)))
    valid = rng.random((B, C)) < p_valid
    valid[:, rng.integers(0, C)] = True          # no row fully masked
    kv_dtype = kv_dtype or dtype
    return (q.to(dtype), k.to(kv_dtype), v.to(kv_dtype),
            torch.from_numpy(valid.astype(np.float32)))


def _jax(t):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _pallas(q, k, v, valid):
    out = flash_decode_call(_jax(q), _jax(k), _jax(v), _jax(valid),
                            interpret=True)
    return torch.tensor(np.asarray(out, np.float32))


def _oracle64(q, k, v, valid):
    """The dense softmax in float64."""
    q, k, v = (t.double().numpy() for t in (q, k, v))
    s = np.einsum("bhgd,bchd->bhgc", q, k) / np.sqrt(q.shape[-1])
    s = np.where(valid.numpy()[:, None, None, :] > 0, s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return torch.from_numpy(np.einsum("bhgc,bchd->bhgd", w, v))


@pytest.mark.parametrize("B,KV,G,dh,nb", [
    (2, 2, 2, 64, 1),
    (1, 2, 8, 128, 2),
    (2, 1, 16, 256, 1),
])
@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)], ids=["f32", "bf16", "f32-bf16cache"])
def test_plain_matches_pallas(B, KV, G, dh, nb, dtype, kv_dtype):
    q, k, v, valid = _inputs(B, KV, G, dh, nb * BLOCK_C, dtype,
                             seed=B * 31 + KV * 7 + dh + nb,
                             kv_dtype=kv_dtype)
    out = flash_decode(q, k, v, valid)        # CPU tensors: the plain version
    assert out.dtype == dtype and out.shape == q.shape
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), _pallas(q, k, v, valid),
                               rtol=tol, atol=tol)


def test_single_valid_token_and_all_masked_row():
    """Row 0 attends to one entry (its output is that v row); row 1 to none
    (uniform weights: the mean of v over C), as the TPU kernel gives."""
    B, KV, G, dh, C = 2, 2, 2, 64, BLOCK_C
    q, k, v, _ = _inputs(B, KV, G, dh, C, torch.float32, seed=9)
    valid = torch.zeros(B, C)
    valid[0, 137] = 1.0
    out = flash_decode(q, k, v, valid)
    torch.testing.assert_close(out, _pallas(q, k, v, valid), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out[0], v[0, 137][:, None].expand(KV, G, dh),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[1], v[1].mean(0)[:, None].expand(KV, G, dh),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("C", [1, 3, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ragged_cache_matches_oracle(C, dtype):
    q, k, v, valid = _inputs(3, 2, 2, 128, C, dtype, seed=C)
    out = flash_decode(q, k, v, valid.bool())
    tol = TOL[dtype]
    torch.testing.assert_close(out.double(), _oracle64(q, k, v, valid),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shapes", [
    ((1, 2, 2, 64), (1, 8, 3, 64), (1, 8)),        # kv heads differ
    ((1, 2, 2, 64), (1, 8, 2, 32), (1, 8)),        # head dims differ
    ((1, 2, 2, 64), (1, 8, 2, 64), (1, 9)),        # mask length
    ((2, 2, 2, 64), (1, 8, 2, 64), (1, 8)),        # batch
])
def test_wrapper_rejects_bad_shapes(shapes):
    qs, ks, vs = shapes
    with pytest.raises(ValueError):
        flash_decode(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks),
                     torch.ones(vs))


def test_wrapper_rejects_mixed_cache_types():
    q = torch.zeros(1, 1, 1, 64)
    k = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError):
        flash_decode(q, k, k.to(torch.bfloat16), torch.ones(1, 4))
    with pytest.raises(ValueError):
        flash_decode(q.double(), k, k, torch.ones(1, 4))


def test_plain_version_is_the_dense_softmax():
    """The plain version is the JAX test's oracle: at bf16 it computes in
    f32 and rounds only its output."""
    q, k, v, valid = _inputs(2, 2, 4, 64, 40, torch.bfloat16, seed=5)
    out = flash_decode_plain(q, k, v, valid)
    ref = _oracle64(q, k, v, valid)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.double(), ref.to(torch.bfloat16).double(),
                               rtol=2.0 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# the kernel's split of the cache over a cluster, and its merge, modelled
# in plain PyTorch: what the CUDA kernel computes, checkable on the CPU
# ---------------------------------------------------------------------------
TILES = sorted({stage_positions(dh, size) for dh in HEAD_DIMS
                for size in (2, 4)})


@pytest.mark.parametrize("C", [1, 5, 8, 255, 256, 257, 777, 1000, 4096,
                               32768])
def test_split_ranges_cover_the_cache_once(C):
    """The SPLITS ranges cover [0, C) exactly once, in rank order, each a
    whole number of tiles long but the last non-empty one; empty ranges
    (C < SPLITS * tile) sit at the end."""
    for tile in TILES:
        per, ranges = split_ranges(C, tile)
        assert len(ranges) == SPLITS and per % tile == 0
        assert per == ((C + SPLITS - 1) // SPLITS + tile - 1) // tile * tile
        covered = np.zeros(C, np.int64)
        end = 0
        for lo, hi in ranges:
            assert lo == end and lo <= hi <= lo + per
            covered[lo:hi] += 1
            end = hi
        assert end == C and (covered == 1).all()
        sizes = [hi - lo for lo, hi in ranges]
        nonempty = [n for n in sizes if n]
        assert all(n == per for n in nonempty[:-1])
        assert sizes == nonempty + [0] * (SPLITS - len(nonempty))


def _merge_model(q, k, v, valid, tile=16):
    """The kernel's arithmetic in f32: each split's (m, l, acc) from the
    -1e30 start (an empty split keeps m = -1e30, l = 0, acc = 0), then the
    splits merged in rank order with the running-max formula, and
    out = acc / max(l, 1e-30)."""
    q, k, v = q.float(), k.float(), v.float()
    B, KV, G, dh = q.shape
    _, ranges = split_ranges(k.shape[1], tile)
    neg = torch.tensor(-1e30)
    M = L = A = None
    for lo, hi in ranges:
        m = torch.full((B, KV, G), -1e30)
        l = torch.zeros(B, KV, G)
        acc = torch.zeros(B, KV, G, dh)
        if hi > lo:
            s = torch.einsum("bhgd,bchd->bhgc", q, k[:, lo:hi]) / \
                torch.sqrt(torch.tensor(float(dh)))
            s = torch.where(valid[:, None, None, lo:hi] > 0, s, neg)
            m = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m[..., None])
            l = p.sum(-1)
            acc = torch.einsum("bhgc,bchd->bhgd", p, v[:, lo:hi])
        if M is None:
            M, L, A = m, l, acc
            continue
        mn = torch.maximum(M, m)
        a, b = torch.exp(M - mn), torch.exp(m - mn)
        L = L * a + l * b
        A = A * a[..., None] + acc * b[..., None]
        M = mn
    return A / torch.clamp(L, min=1e-30)[..., None]


def _mask(kind, B, C, rng):
    valid = rng.random((B, C)) < 0.6
    valid[:, rng.integers(0, C)] = True
    if kind == "all-masked row":
        valid[0] = False
    elif kind == "one split":
        # every valid entry of row 0 inside one split's range
        _, ranges = split_ranges(C, 16)
        lo, hi = max(ranges, key=lambda r: r[1] - r[0])
        valid[0] = False
        valid[0, lo:hi] = rng.random(hi - lo) < 0.5
        valid[0, (lo + hi) // 2] = True
    return torch.from_numpy(valid)


@pytest.mark.parametrize("C,kind", [
    (1, "random"), (5, "random"), (9, "all-masked row"), (100, "one split"),
    (777, "random"), (1000, "all-masked row"), (512, "random"),
    (1024, "one split")])
def test_merge_model_matches_plain(C, kind):
    """The split-and-merge model against the plain version within 1e-5,
    and against the Pallas kernel (interpret mode) where C % 512 == 0;
    ragged C, C < SPLITS, an all-masked row (the mean of v) and a row whose
    valid entries all lie in one split."""
    rng = np.random.default_rng(C)
    q, k, v, _ = _inputs(2, 2, 3, 64, C, torch.float32, seed=C)
    valid = _mask(kind, 2, C, rng)
    out = _merge_model(q, k, v, valid)
    torch.testing.assert_close(out, flash_decode_plain(q, k, v, valid),
                               rtol=1e-5, atol=1e-5)
    if kind == "all-masked row":
        torch.testing.assert_close(out[0], v[0].mean(0)[:, None].expand(
            2, 3, 64), rtol=1e-5, atol=1e-5)
    if C % BLOCK_C == 0:
        torch.testing.assert_close(out, _pallas(q, k, v, valid.float()),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dh = 80 (zamba2-2.7b's head width)
# ---------------------------------------------------------------------------
def test_stage_positions_at_every_head_width():
    """The tile is the rows of K and V 8 KB hold, cut to a whole number of
    the kernel's warp loads (4 consumer warps x 32 / lanes-a-row rows, a
    row read by the next power of two of 16-byte vectors' lanes): the
    power-of-two widths keep 8 KB exactly, dh 80 cuts 25 rows to 24 over
    bf16 and keeps 12 over f32; V's tile starts on a 128-byte boundary."""
    want = {(64, 2): 32, (80, 2): 24, (128, 2): 16, (256, 2): 8,
            (64, 4): 16, (80, 4): 12, (128, 4): 8, (256, 4): 4}
    assert 80 in HEAD_DIMS
    for (dh, size), tile in want.items():
        assert stage_positions(dh, size) == tile, (dh, size)
        row = dh * size
        lanes = 1 << (row // 16 - 1).bit_length()
        assert tile % (4 * max(1, 32 // lanes)) == 0
        assert tile * row % 128 == 0 and 2 * tile * row <= 8192


@pytest.mark.parametrize("C", [1, 23, 24, 25, 191, 192, 193, 4096])
def test_split_ranges_at_dh80(C):
    """The splits at dh 80's tiles: whole tiles of 24 (bf16) or 12 (f32)
    positions, covering [0, C) once."""
    for tile in (stage_positions(80, 2), stage_positions(80, 4)):
        per, ranges = split_ranges(C, tile)
        assert per % tile == 0 and per >= -(-C // SPLITS)
        assert ranges[0][0] == 0 and ranges[-1][1] == C
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("C,kind", [(100, "one split"), (777, "random"),
                                    (9, "all-masked row")])
def test_merge_model_matches_plain_dh80(C, kind):
    """The split-and-merge model at dh 80 and the bf16 cache's tile of 24
    positions against the plain version within 1e-5."""
    rng = np.random.default_rng(C + 80)
    q, k, v, _ = _inputs(2, 4, 1, 80, C, torch.float32, seed=C + 80)
    valid = _mask(kind, 2, C, rng)
    torch.testing.assert_close(
        _merge_model(q, k, v, valid, tile=stage_positions(80, 2)),
        flash_decode_plain(q, k, v, valid), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_plain_matches_repro_attn_decode_dh80(cache):
    """The port's decode attention (K6's plain version on the CPU) on a
    zamba2-smoke cache with d_head = 80 (zamba2-2.7b's head width, G = 1)
    against the JAX package's ``attn_decode``: the output within 1e-5 over
    an f32 cache; over a bf16 cache within 3e-2 (the reference rounds its
    softmax weights and output to the cache type, K6 keeps f32); the
    updated caches' positions and cursors equal, the new k/v entry within
    1e-5 (f32) or one bf16 ulp."""
    import dataclasses

    import jax
    from repro.models import blocks as RB
    from repro.models.registry import get_config as r_get_config
    from repro_torch.models import blocks as PB
    from repro_torch.models.registry import get_config

    rcfg = dataclasses.replace(r_get_config("zamba2-2.7b", smoke=True),
                               d_head=80)
    pcfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True),
                               d_head=80)
    rdt, pdt = ((jnp.float32, torch.float32) if cache == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rp = RB.attn_init(jax.random.PRNGKey(0), rcfg)
    pp = {k_: torch.tensor(np.asarray(a)) for k_, a in rp.items()}
    rng = np.random.default_rng(80)
    B, C, n = 3, 40, np.array([5, 17, 39])
    kv = rng.standard_normal((2, B, C, rcfg.n_kv, 80)).astype(np.float32)
    pos = np.where(np.arange(C)[None] < n[:, None], np.arange(C)[None],
                   -1).astype(np.int32)
    rc = {"k": jnp.asarray(kv[0], rdt), "v": jnp.asarray(kv[1], rdt),
          "pos": jnp.asarray(pos), "idx": jnp.asarray(n, jnp.int32)}
    pc = {"k": torch.from_numpy(kv[0]).to(pdt),
          "v": torch.from_numpy(kv[1]).to(pdt),
          "pos": torch.from_numpy(pos), "idx": torch.from_numpy(
              n.astype(np.int32))}
    x = rng.standard_normal((B, 1, rcfg.d_model)).astype(np.float32)
    qpos = n[:, None].astype(np.int32)
    ry, rc = jax.jit(lambda p, x_, q_, c_: RB.attn_decode(
        p, x_, rcfg, q_, c_))(rp, jnp.asarray(x), jnp.asarray(qpos), rc)
    py, pc = PB.attn_decode(pp, torch.from_numpy(x), pcfg,
                            torch.from_numpy(qpos), pc)
    tol = 1e-5 if cache == "f32" else 3e-2
    torch.testing.assert_close(py, torch.tensor(np.asarray(ry, np.float32)),
                               rtol=tol, atol=tol)
    for key in ("pos", "idx"):
        assert np.array_equal(np.asarray(rc[key]), pc[key].numpy()), key
    for key in ("k", "v"):       # the new entry: f32 projections and RoPE
        torch.testing.assert_close(      # in another order, then the cast
            pc[key].float(), torch.tensor(np.asarray(rc[key], np.float32)),
            rtol=1e-5 if cache == "f32" else 2.0 ** -7, atol=1e-5)
