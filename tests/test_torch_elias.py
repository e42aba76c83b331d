"""The Elias-omega payload coder of the port against the JAX package: the
words bit for bit and ``nbits`` equal (one stream a row of a batch), the
decode's plain version (the walk the ``elias_decode`` kernel makes on the
card) against ``decode_levels``, the pricing bounds, and the codec's
"elias" payload.  Inputs come from numpy with fixed seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as RC
from repro.compress import elias as RE
from repro_torch import compress as PC
from repro_torch.compress import elias as E
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
