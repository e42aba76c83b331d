"""ErrorFeedbackCodec in the port against the JAX package: levels and
residual state equal given the same noise, the telescoping contract, the
refusal to be priced, and EF around rotated and bucketed inner codecs.
Inputs and noise come from numpy with fixed seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as RC
from repro_torch import compress as PC


def _stream(dim, steps, seed, m=None):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield (rng.standard_normal(dim).astype(np.float32),
               rng.random(m or dim, dtype=np.float32))


@pytest.mark.parametrize("inner", [
    dict(s=4), dict(s=7, wire="int4"), dict(s=127, bucket=64),
    dict(s=2**14)], ids=["s4", "int4", "bucket64", "s16384"])
def test_ef_levels_and_state_equal_reference(inner):
    """Ten stateful encodes, each package fed the same noise: the levels
    equal the JAX package's bit for bit, the norms within rtol 1e-6, and
    the residual within that tolerance of the norm carried through the
    decode (|level| / s <= 1 a step), summed over the steps so far."""
    dim = 1000
    s = inner.pop("s")
    ef = PC.ErrorFeedbackCodec(inner=PC.make_codec(s, **inner))
    ref = RC.ErrorFeedbackCodec(inner=RC.make_codec(s, **inner))
    state, rstate = ef.init_state(dim, device="cpu"), ref.init_state(dim)
    assert state.shape == (dim,) and state.device.type == "cpu"
    tol = 0.0
    for y, u in _stream(dim, 10, seed=s):
        lvl, norm, state = ef.encode(torch.from_numpy(y),
                                     torch.from_numpy(u), state)
        rl, rn, rstate = ref.encode(jnp.asarray(y), jnp.asarray(u), rstate)
        np.testing.assert_array_equal(lvl.numpy(), np.asarray(rl))
        np.testing.assert_allclose(norm.numpy(), np.asarray(rn), rtol=1e-6)
        tol += 1e-6 * float(norm.max())
        np.testing.assert_allclose(state.numpy(), np.asarray(rstate),
                                   rtol=0, atol=tol)
    assert ef.wire_bits(dim) == ref.wire_bits(dim)
    assert ef.s == s and ef.wire == ref.wire


def test_ef_quantize_dequantize_equals_reference_given_u():
    dim = 500
    ef = PC.ErrorFeedbackCodec(inner=PC.make_codec(8, backend="cuda"))
    ref = RC.ErrorFeedbackCodec(inner=RC.make_codec(8))
    state, rstate = ef.init_state(dim, device="cpu"), ref.init_state(dim)
    for y, u in _stream(dim, 5, seed=2):
        out, state = ef.quantize_dequantize(torch.from_numpy(y),
                                            torch.from_numpy(u), state)
        comp = jnp.asarray(y) + rstate
        rl, rn = ref.inner.encode(comp, jnp.asarray(u))
        rout = ref.inner.decode(rl, rn)
        rstate = comp - rout
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(state.numpy(), np.asarray(rstate),
                                   atol=1e-5)


def test_ef_telescoping_contract():
    """sum_t decode_t == sum_t y_t + e_0 - e_T, to f32 summation noise."""
    dim = 256
    ef = PC.ErrorFeedbackCodec(inner=PC.make_codec(4))
    state = ef.init_state(dim, device="cpu")
    tot_in = torch.zeros(dim)
    tot_out = torch.zeros(dim)
    for y, u in _stream(dim, 40, seed=0):
        out, state = ef.quantize_dequantize(torch.from_numpy(y),
                                            torch.from_numpy(u), state)
        tot_in += torch.from_numpy(y)
        tot_out += out
    torch.testing.assert_close(tot_in - tot_out, state, atol=1e-3, rtol=0)


def test_ef_residual_stays_bounded():
    """With a contractive inner quantizer (q_s < 1) the residual stays
    within q/(1-q) of the largest input, in sqrt form (the JAX package's
    bound)."""
    dim, s = 64, 32
    q = PC.variance_bound(s, dim)
    assert q < 1.0
    ef = PC.ErrorFeedbackCodec(inner=PC.make_codec(s))
    state = ef.init_state(dim, device="cpu")
    max_in = max_res = 0.0
    for y, u in _stream(dim, 60, seed=1):
        _, state = ef.quantize_dequantize(torch.from_numpy(y),
                                          torch.from_numpy(u), state)
        max_in = max(max_in, float(np.linalg.norm(y)))
        max_res = max(max_res, float(torch.linalg.vector_norm(state)))
    assert max_res <= np.sqrt(q) / (1.0 - np.sqrt(q)) * max_in * 1.1


def test_ef_refuses_optimizer_pricing_and_defaults_to_the_card(monkeypatch):
    ef = PC.ErrorFeedbackCodec(inner=PC.make_codec(4))
    with pytest.raises(TypeError, match="biased"):
        ef.variance_bound(100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ef.init_state(10)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_ef_around_rotated_inner(backend):
    """EF composes with the rotated codec: the state lives in model space
    (the padded decode cut to the message), y - out is the new state, and
    the stateful encode's state equals quantize_dequantize's given u."""
    dim = 200
    ef = PC.ErrorFeedbackCodec(inner=PC.make_codec(8, kind="rotated",
                                                   backend=backend))
    m = ef.inner.padded_dim(dim)
    (y, u), = _stream(dim, 1, seed=8, m=m)
    y, u = torch.from_numpy(y), torch.from_numpy(u)
    state = ef.init_state(dim, device="cpu")
    out, new = ef.quantize_dequantize(y, u, state)
    assert out.shape == y.shape and new.shape == (dim,)
    torch.testing.assert_close(y - out, new, atol=1e-5, rtol=0)
    lvl, norm, new_e = ef.encode(y, u, state)
    assert lvl.shape == (m,)
    torch.testing.assert_close(new_e, new, atol=1e-6, rtol=0)
    rout, rnew = RC.ErrorFeedbackCodec(inner=RC.make_codec(
        8, kind="rotated")).encode(jnp.asarray(y.numpy()),
                                   jnp.asarray(u.numpy()),
                                   jnp.zeros(dim))[::2]
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(rout))
    np.testing.assert_allclose(new_e.numpy(), np.asarray(rnew), atol=1e-5)
