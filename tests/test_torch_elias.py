"""The Elias-omega payload coder of the port against the JAX package: the
words bit for bit and ``nbits`` equal (one stream a row of a batch), the
decode's plain version (the walk the ``elias_decode`` kernel makes on the
card) against ``decode_levels``, the pricing bounds, and the codec's
"elias" payload.  Inputs come from numpy with fixed seeds."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as RC
from repro.compress import elias as RE
from repro_torch import compress as PC
from repro_torch.compress import elias as E
from repro_torch.kernels import build
from repro_torch.kernels import elias as KE

#: lengths: empty, one coordinate, a partial word, a word boundary, and
#: the payload tests' message length (each new length costs the JAX
#: package a compile of its coder)
DS = [0, 1, 7, 64, 4097]
N_MSG = 4097
PATTERNS = ["zeros", "dense", "sparse", "ends", "boundary"]


def _levels(d, pattern, rng):
    """The JAX package's test patterns (tests/unit/test_elias.py)."""
    lv = np.zeros(d, np.int8)
    if d == 0:
        return lv
    if pattern == "dense":
        lv = rng.integers(-127, 128, d).astype(np.int8)
    elif pattern == "sparse":
        idx = rng.choice(d, max(1, d // 40), replace=False)
        lv[idx] = (rng.integers(1, 8, idx.size)
                   * rng.choice([-1, 1], idx.size)).astype(np.int8)
    elif pattern == "ends":
        lv[0], lv[-1] = 7, -7
    elif pattern == "boundary":
        lv[: min(d, 4)] = [127, -127, 1, -1][: min(d, 4)]
    return lv


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def _i32(words) -> torch.Tensor:
    """The JAX package's uint32 words as the port's int32 words."""
    return torch.from_numpy(np.array(words).view(np.int32))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_words_and_nbits_bitwise_reference(pattern):
    """For every length: the int32 words are the JAX package's uint32
    words bit for bit, nbits and ``stream_bits`` equal its nbits, and both
    decodes (the plain walk and ``decode_levels``) give the input back."""
    rng = np.random.default_rng(len(pattern))
    for d in DS:
        lv = _levels(d, pattern, rng)
        words, nbits = E.encode_levels(torch.from_numpy(lv))
        rw, rn = RE.encode_levels(jnp.asarray(lv))
        assert words.dtype == torch.int32
        assert words.shape == (E.word_capacity(d),) == rw.shape
        np.testing.assert_array_equal(_u32(words), np.asarray(rw))
        assert int(nbits) == int(rn) == int(E.stream_bits(
            torch.from_numpy(lv)))
        back = E.decode_levels(words, d)
        assert back.dtype == torch.int8
        np.testing.assert_array_equal(back.numpy(), lv)
        np.testing.assert_array_equal(
            KE.elias_decode_plain(_i32(rw), d).numpy(), lv)


def test_plain_decode_equals_reference_decode():
    """The plain walk and the JAX package's ``decode_levels`` agree on the
    same words, for QSGD levels at s in {7, 127} (sparse and dense)."""
    rng = np.random.default_rng(9)
    d = N_MSG
    dec = jax.jit(lambda w: RE.decode_levels(w, d))
    for s in (7, 127):
        y = rng.standard_normal(d).astype(np.float32)
        u = rng.random(d, dtype=np.float32)
        lvl, _ = RC.encode_tensor(jnp.asarray(y), s, jnp.asarray(u))
        rw, _ = RE.encode_levels(lvl)
        ref = np.asarray(dec(rw))
        ours = E.decode_levels(_i32(rw), d)
        np.testing.assert_array_equal(ours.numpy(), ref)
        np.testing.assert_array_equal(ref, np.asarray(lvl))


def test_rows_are_streams_of_their_own():
    """A batch of rows codes each row as its own stream: each row's words
    and nbits are the JAX package's 1-D call on that row."""
    rng = np.random.default_rng(0)
    lv = np.stack([_levels(300, p, rng) for p in ("sparse", "dense",
                                                  "zeros")])
    words, nbits = E.encode_levels(torch.from_numpy(lv))
    assert words.shape == (3, E.word_capacity(300)) and nbits.shape == (3,)
    for r in range(3):
        rw, rn = RE.encode_levels(jnp.asarray(lv[r]))
        np.testing.assert_array_equal(_u32(words[r]), np.asarray(rw))
        assert int(nbits[r]) == int(rn)
    np.testing.assert_array_equal(E.decode_levels(words, 300).numpy(), lv)
    np.testing.assert_array_equal(E.stream_bits(torch.from_numpy(lv))
                                  .numpy(), nbits.numpy())


def test_decode_wrapper_refuses_and_counts_nothing_on_cpu():
    KE.reset_launches()
    words, _ = E.encode_levels(torch.tensor([0, 3, 0, -1], dtype=torch.int8))
    assert E.decode_levels(words, 4).tolist() == [0, 3, 0, -1]
    assert KE.LAUNCHES["elias_decode"] == 0
    with pytest.raises(ValueError, match="int32"):
        KE.elias_decode(words.to(torch.int64), 4)
    with pytest.raises(ValueError, match="2\\^24"):
        E.encode_levels(torch.zeros(1 << 24, dtype=torch.int8))


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------
def test_omega_lengths_and_capacity():
    assert [E.omega_length(n) for n in (1, 2, 3, 4, 7, 8, 15, 16)] == \
        [1, 3, 3, 6, 6, 7, 7, 11]
    vals = [E.omega_max_bits(s) for s in range(1, 200)]
    assert all(b >= a for a, b in zip(vals, vals[1:]))
    assert E.omega_max_bits(7) == 8 and E.omega_max_bits(127) == 15
    for d in (0, 1, 1000, 101770):
        assert E.word_capacity(d) == RE.word_capacity(d)


@pytest.mark.parametrize("d,s", [(257, 1), (16387, 5), (65536, 7)])
def test_realized_bits_bounded_by_pricing(d, s):
    """The realized stream fits the worst-case arm and, on these seeds,
    the priced min(worst, expected) that wire_bits charges (the JAX
    package's bounds)."""
    rng = np.random.default_rng(d + s)
    y = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    u = torch.from_numpy(rng.random(d, dtype=np.float32))
    lvl, _ = PC.encode_tensor(y, s, u)
    bits = int(E.stream_bits(lvl))
    assert bits <= d * E.omega_max_bits(s) + E._TERM_BITS
    assert bits <= E.payload_bits(s, d)
    assert PC.wire_bits(s, d, "elias") == 32.0 + E.payload_bits(s, d)


# ---------------------------------------------------------------------------
# the codec's "elias" payload
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bucket,s", [(None, 7), (None, 127), (1000, 7),
                                      (1000, 127)])
def test_elias_payload_matches_reference(bucket, s):
    """``encode_payload`` on wire "elias", on both backends: the words bit
    for bit and nbits the JAX package's, the norms within rtol 1e-6, and
    ``decode_payload`` equal to ``decode(*encode(y, u))``."""
    rng = np.random.default_rng(s + (bucket or 0))
    y = rng.standard_normal(N_MSG).astype(np.float32) * 3
    u = rng.random(N_MSG, dtype=np.float32)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    rcodec = RC.make_codec(s, wire="elias", bucket=bucket)
    rw, rn, rbits = rcodec.encode_payload(jnp.asarray(y), jnp.asarray(u))
    for backend in ("torch", "cuda"):
        codec = PC.make_codec(s, wire="elias", bucket=bucket,
                              backend=backend)
        words, norm, nbits = codec.encode_payload(yt, ut)
        np.testing.assert_array_equal(_u32(words), np.asarray(rw))
        assert int(nbits) == int(rbits)
        np.testing.assert_allclose(norm.numpy(), np.asarray(rn), rtol=1e-6)
        dec = codec.decode_payload(words, norm, N_MSG)
        assert torch.equal(dec, codec.decode(*codec.encode(yt, ut)))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_rotated_elias_payload_round_trips(backend):
    """The rotated codec's "elias" payload codes the padded rotated levels
    and decodes to ``decode(*encode(y, u))``."""
    rng = np.random.default_rng(3)
    codec = PC.make_codec(7, wire="elias", kind="rotated", backend=backend)
    m = codec.padded_dim(N_MSG)
    y = torch.from_numpy(rng.standard_normal(N_MSG).astype(np.float32))
    u = torch.from_numpy(rng.random(m, dtype=np.float32))
    words, norm, nbits = codec.encode_payload(y, u)
    lvl, norm_e = codec.encode(y, u)
    assert words.shape == (E.word_capacity(m),) and torch.equal(norm, norm_e)
    assert int(nbits) == int(E.stream_bits(lvl))
    assert torch.equal(codec.decode_payload(words, norm, m),
                       codec.decode(lvl, norm_e))


def test_elias_payload_batched_and_wide_s():
    """Rows of a batch are messages (nbits is their total); s > 127 is
    refused (the JAX package's payload wraps such levels through int8)."""
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((3, 2000)).astype(np.float32))
    u = torch.from_numpy(rng.random((3, 2000), dtype=np.float32))
    codec = PC.make_codec(127, wire="elias", backend="cuda")
    words, norm, nbits = codec.encode_payload(y, u)
    assert words.shape == (3, E.word_capacity(2000)) and norm.shape == (3,)
    assert int(nbits) == sum(int(codec.encode_payload(y[r], u[r])[2])
                             for r in range(3))
    assert torch.equal(codec.decode_payload(words, norm, 2000),
                       codec.decode(*codec.encode(y, u)))
    wide = PC.make_codec(2**14, wire="elias")
    assert wide.wire_bits(2000) == RC.make_codec(
        2**14, wire="elias").wire_bits(2000)
    with pytest.raises(ValueError, match="127"):
        wide.encode_payload(y[0], u[0])


# ---------------------------------------------------------------------------
# a NumPy model of the kernel's parallel decode (csrc/elias.cu)
# ---------------------------------------------------------------------------
C, W, S = KE.CHUNK_BITS, KE.WINDOW, KE.SEGMENT_CHUNKS
BAD = 255
END, LONG, STOP = 0, 1, 2
SAT = 0xFFFFFFFF


def _rev32(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0xFFFF) << 16) | ((x >> 16) & 0xFFFF)


def _word(w, i):
    """Words past the row's capacity read as zeros."""
    return np.where(i < w.size, w[np.minimum(i, w.size - 1)], 0)


def _walk(w, start, end, pos, d=None, out=None):
    """``walk<>`` in lockstep over many walkers: each trip reads one omega
    group (or ends a codeword) for every walker still running.  Table mode
    (d None): pos sums the gaps; a gap group longer than 32 bits ends the
    walk.  Decode mode: the stop rule, and levels written into ``out``.
    -> (bit, pos, status) of each walker."""
    bit, pos = start.astype(np.int64), pos.astype(np.int64)
    status = np.where(bit >= end, END, -1)
    n = np.ones(bit.size, np.int64)
    gap = np.ones(bit.size, bool)
    while True:
        a = np.flatnonzero(status < 0)
        if a.size == 0:
            return bit, pos, status
        b = bit[a]
        lo = _word(w, b >> 5) | (_word(w, (b >> 5) + 1) << np.uint64(32))
        win = (lo >> (b & 31).astype(np.uint64)).astype(np.int64)
        ln = n[a] + 1
        one = (win & 1) == 1
        grp = one & (ln <= 32)
        g_a = a[grp]
        m = (np.int64(1) << ln[grp]) - 1
        n[g_a] = _rev32(win[grp] & m) >> (32 - ln[grp])
        bit[g_a] += ln[grp]
        longg = one & (ln > 32)
        status[a[longg & gap[a]]] = LONG
        zero_lvl = longg & ~gap[a]             # level 0, the sign this 1
        gap_end = ~one & gap[a]
        e_a = a[gap_end]
        bit[e_a] += 1
        if d is not None:
            stop = pos[e_a] + n[e_a] >= d
            status[e_a[stop]] = STOP
            e_a = e_a[~stop]
        pos[e_a] += n[e_a]
        gap[e_a] = False
        n[e_a] = 1
        lvl_end = ~one & ~gap[a]
        lvl_end[gap_end] = False               # gap[] changed above
        t_a = a[zero_lvl | lvl_end]
        level = np.where(zero_lvl, 0, n[a])[zero_lvl | lvl_end]
        neg = np.where(zero_lvl, 1, (win >> 1) & 1)[zero_lvl | lvl_end]
        bit[t_a] += np.where(zero_lvl, 1, 2)[zero_lvl | lvl_end]
        if d is not None:
            v = np.where(neg == 1, -level, level) & 0xFF
            out[pos[t_a]] = (np.where(v > 127, v - 256, v)).astype(np.int8)
        done = bit[t_a] >= end[t_a]
        status[t_a[done]] = END
        gap[t_a[~done]] = True
        n[t_a[~done]] = 1


def _model_row(w, d, out):
    """The kernel's passes on one row's words ``w`` (uint64 values of the
    uint32 words) into the zeroed ``out``.  -> True where the row took the
    sequential walk (malformed)."""
    nz = np.flatnonzero(w)                                   # 1 extent
    zbits = 32 * (int(nz[-1]) + 1 if nz.size else 0)
    nch = max(1, -(-zbits // C))
    nseg = -(-nch // S)
    c = np.repeat(np.arange(nch), W)                         # 2 tables
    e = np.tile(np.arange(W), nch)
    start = c * C + e
    prev = np.maximum(start - 2, 0)
    bit2 = (_word(w, prev >> 5) >> (prev & 31).astype(np.uint64)) & 1
    cand = np.where(c == 0, e == 0, bit2 == 0)
    x = np.full(c.size, BAD, np.int64)
    adv = np.zeros(c.size, np.int64)
    i = np.flatnonzero(cand)
    end = (c[i] + 1) * C
    bit, a, st = _walk(w, start[i], end, np.zeros(i.size, np.int64))
    ex = bit - end
    x[i] = np.where(st != END, BAD, np.where(
        c[i] == nch - 1, 0, np.where(ex < W, ex, BAD)))
    adv[i] = np.minimum(a, SAT)
    tx, ta = x.reshape(nch, W), adv.reshape(nch, W)
    pre_x = np.full((nseg, W, S), BAD, np.int64)
    pre_a = np.zeros((nseg, W, S), np.int64)
    comp_x = np.empty((nseg, W), np.int64)
    comp_a = np.empty((nseg, W), np.int64)
    for seg in range(nseg):
        stt, rel = np.arange(W), np.zeros(W, np.int64)
        for q in range(min(S, nch - seg * S)):
            pre_x[seg, :, q], pre_a[seg, :, q] = stt, np.minimum(rel, SAT)
            ok = stt != BAD
            rel[ok] += ta[seg * S + q, stt[ok]]
            stt = np.where(ok, tx[seg * S + q, np.where(ok, stt, 0)], BAD)
        comp_x[seg], comp_a[seg] = stt, np.minimum(rel, SAT)
    ok = comp_x != BAD                                       # 3 resolve
    lo = np.where(ok, comp_x, BAD).min(axis=1)
    hi = np.where(ok, comp_x, -1).max(axis=1)
    comp_c = np.where(hi < 0, BAD, np.where(lo == hi, lo, -1))
    seg_e = np.r_[0, comp_c[:-1]]
    for k in range(1, nseg):             # behind a table of varying exits
        if seg_e[k] < 0:
            prev = seg_e[k - 1]
            seg_e[k] = BAD if prev == BAD else comp_x[k - 1, prev]
    known = seg_e != BAD
    e0 = np.where(known, seg_e, 0)
    a = np.where(known, comp_a[np.arange(nseg), e0], 0)
    xk = np.where(known, comp_x[np.arange(nseg), e0], BAD)
    seg_p = -1 + np.cumsum(a) - a
    bad = bool((~known & (seg_p < d)).any() or
               ((xk == BAD) & (seg_p + a < d)).any())
    p = -1 + int(a.sum())
    if bad:                                                  # sequential
        _, pos, st = _walk(w, np.zeros(1), np.array([zbits]),
                           np.array([-1]), d, out)
        tail = min(pos[0] + 1, d) if st[0] == END else d
    else:                                                    # 4 decode
        tail = min(p + 1, d)
        ch = np.arange(nch)
        sg = ch // S
        p0 = seg_p[sg]
        live = np.flatnonzero(p0 < d)
        ent = pre_x[sg[live], seg_e[sg[live]], ch[live] % S]
        pos = p0[live] + pre_a[sg[live], seg_e[sg[live]], ch[live] % S]
        keep = pos < d
        assert (ent[keep] != BAD).all()
        cl = ch[live][keep]
        _walk(w, cl * C + ent[keep], (cl + 1) * C, pos[keep], d, out)
    out[tail:] = 1
    return bad


def _model_decode(words: torch.Tensor, d: int):
    """-> (int8 levels (rows, d), rows taken by the sequential walk)."""
    w = words.reshape(-1, words.shape[-1]).numpy().view(np.uint32)
    out = np.zeros((w.shape[0], d), np.int8)
    bad = sum(_model_row(w[r].astype(np.uint64), d, out[r]) for r in
              range(w.shape[0]))
    return out, bad


def _model_case(name, rng):
    """(words (rows, cap) int32, d, levels or None, malformed rows or
    None: at least one)."""
    if name.startswith("pattern-"):
        pattern = name[len("pattern-"):]
        lv = np.stack([_levels(4097, pattern, rng),
                       _levels(4097, pattern, rng)])
    elif name == "all-127":            # a triple a coordinate, 15 bits each
        lv = (rng.choice([-127, 127], (2, 3001))).astype(np.int8)
    elif name == "ones-tail":          # the +1 run decodes from zero bits
        lv = _levels(3000, "sparse", rng)
        lv[1700:] = 1
    elif name == "ones-run":           # zero bits inside the stream: walks
        lv = _levels(6000, "sparse", rng)   # from offsets 3 apart never meet
        lv[1000:4000] = 1
    elif name == "d1":
        lv = np.array([[0], [-5]], np.int8)
    elif name == "long-gap":           # a 2^20 + 2 gap codeword
        lv = np.zeros((1, (1 << 20) + 3), np.int8)
        lv[0, -1] = -3
    if name in ("random", "truncated"):
        d = 4097
        if name == "random":
            words = torch.from_numpy(rng.integers(
                -2**31, 2**31, (8, E.word_capacity(d)), dtype=np.int64)
                .astype(np.int32))
            return words, d, None, 1
        lv = _levels(d, "dense", rng)[None]
        words, nbits = E.encode_levels(torch.from_numpy(lv))
        u = words.numpy().view(np.uint32).copy()
        cut = int(nbits[0]) // 2 + 3         # inside a codeword
        u[0, cut // 32] &= np.uint32((1 << (cut % 32)) - 1)
        u[0, cut // 32 + 1:] = 0
        return torch.from_numpy(u.view(np.int32)), d, None, None
    words, _ = E.encode_levels(torch.from_numpy(lv))
    return words, lv.shape[-1], lv, 0


MODEL_CASES = ([f"pattern-{p}" for p in PATTERNS]
               + ["all-127", "ones-tail", "ones-run", "d1", "long-gap",
                  "random", "truncated"])


@pytest.mark.parametrize("name", MODEL_CASES)
def test_parallel_decode_model_equals_plain_walk(name):
    """The kernel's passes (extent, entry tables, segment composition,
    resolve from each segment's one exit, decode with the zero tail, the
    sequential walk of a malformed row) modelled in NumPy with the
    wrapper's CHUNK_BITS, WINDOW and SEGMENT_CHUNKS (the tables computed
    walk by walk: the kernel's walks that meet and link give the same):
    levels equal to the plain walk's on encoder streams (and to their
    levels), on random words and on a stream cut inside a codeword; no
    encoder row takes the sequential walk, random words do."""
    rng = np.random.default_rng(sum(map(ord, name)))
    words, d, lv, want_bad = _model_case(name, rng)
    got, bad = _model_decode(words, d)
    np.testing.assert_array_equal(got, KE.elias_decode_plain(words, d)
                                  .numpy().reshape(got.shape))
    if lv is not None:
        np.testing.assert_array_equal(got, lv.reshape(got.shape))
    if want_bad == 0:
        assert bad == 0
    elif want_bad:
        assert bad >= want_bad


def test_kernel_constants_match_wrapper():
    """``csrc/elias.cu`` holds the wrapper's chunk, window and segment
    sizes (its entry point refuses others), and the window covers the
    longest triple of an encoder stream."""
    src = open(os.path.join(build.CSRC_DIR, "elias.cu")).read()
    for name, val in (("kChunkBits", KE.CHUNK_BITS), ("kWindow", KE.WINDOW),
                      ("kSegChunks", KE.SEGMENT_CHUNKS)):
        assert f"constexpr int {name} = {val};" in src
    longest = E._TERM_BITS + max(E.omega_length(m) for m in range(1, 128)) + 1
    assert longest <= KE.WINDOW <= KE.CHUNK_BITS
