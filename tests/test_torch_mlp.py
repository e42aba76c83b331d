"""The port's MLP, flat layout and pre-training probe against the JAX
package's, with weights and mini-batch draws carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.genqsgd import flatten_like as r_flatten
from repro.data.synthetic import mnist_like as r_mnist_like
from repro.models import mlp as RM
from repro_torch.core.genqsgd import flatten_like, unflatten_like
from repro_torch.data.synthetic import mnist_like
from repro_torch.models import mlp as PM


@pytest.fixture(scope="module")
def data():
    X, y = mnist_like(n=8192)
    Xr, yr = r_mnist_like(n=8192)
    assert np.array_equal(X, Xr) and np.array_equal(y, yr)
    return X, y


def _params(seed):
    p = RM.init_params(jax.random.PRNGKey(seed))
    return p, PM.params_from_jax({k: np.asarray(v) for k, v in p.items()},
                                 device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_flat_layout_matches_jax_tree_order(seed):
    """Sorted names (b1, b2, w1, w2): the order jax.tree.leaves gives, so
    injected noise lands on the same coordinates."""
    rp, pp = _params(seed)
    flat = flatten_like(pp)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(r_flatten(rp)))
    assert flat.shape == (PM.PARAM_DIM,)
    back = unflatten_like(flat, {k: v.shape for k, v in pp.items()})
    assert all(torch.equal(back[k], pp[k]) for k in PM.KEYS)


@pytest.mark.parametrize("batch", [1, 64])
def test_loss_and_grad_match(data, batch):
    """Loss and gradient within rtol 1e-5 (float32 sums in another order)."""
    X, y = data
    rp, pp = _params(3)
    Xb, yb = X[:batch], y[:batch]
    l_r, g_r = jax.jit(jax.value_and_grad(RM.loss))(
        rp, (jnp.asarray(Xb), jnp.asarray(yb)))
    ps = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    l_p = PM.loss(ps, (torch.from_numpy(Xb), torch.from_numpy(yb).long()))
    g_p = torch.autograd.grad(l_p, [ps[k] for k in PM.KEYS])
    np.testing.assert_allclose(float(l_p.detach()), float(l_r), rtol=1e-5)
    for k, g in zip(PM.KEYS, g_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r[k]), rtol=1e-5,
                                   atol=1e-7)


def test_batched_loss_is_per_worker_loss(data):
    """Parameters with a leading worker axis give each worker's own loss."""
    X, y = data
    ps = [_params(s)[1] for s in range(3)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in PM.KEYS}
    Xb = torch.from_numpy(X[:48]).reshape(3, 16, 784)
    yb = torch.from_numpy(y[:48]).long().reshape(3, 16)
    got = PM.loss(stacked, (Xb, yb))
    want = torch.stack([PM.loss(p, (Xb[i], yb[i])) for i, p in enumerate(ps)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_accuracy_matches(data):
    X, y = data
    rp, pp = _params(4)
    assert PM.accuracy(pp, torch.from_numpy(X), torch.from_numpy(y)) == \
        pytest.approx(RM.accuracy(rp, jnp.asarray(X), jnp.asarray(y)),
                      abs=1.5 / len(y))


def test_estimate_constants_match(data):
    """Same start point and the JAX package's mini-batch indices: L, sigma,
    G and f_gap within rtol 1e-3 — 20 SGD steps of float32 arithmetic in
    another order drift apart by about 1e-6, and L is a ratio of norms of
    differences along that path."""
    X, y = data
    n_iters, n_probe = 20, 2
    key = jax.random.PRNGKey(0)
    ref = RM.estimate_constants(X, y, key, n_iters=n_iters, n_probe=n_probe)
    # re-derive the draws of the JAX probe: init from `key`, then one
    # split per step
    rp = RM.init_params(key)
    idx = []
    for _ in range(n_iters):
        key, k = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(k, (256,), 0, X.shape[0])))
    got = PM.estimate_constants(
        torch.from_numpy(X), torch.from_numpy(y).long(), n_iters=n_iters,
        n_probe=n_probe,
        params=PM.params_from_jax({k: np.asarray(v) for k, v in rp.items()},
                                  device="cpu"),
        idx=torch.from_numpy(np.stack(idx)).long())
    for name in ("L", "sigma", "G", "f_gap", "f0", "f_star"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-3,
                                   err_msg=name)
