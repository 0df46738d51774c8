"""COSNE and its autodiff row log-sum in the port against the JAX package.

Tolerances:

- the row log-sum at n = 301 with blocks of 64 (a padded last block), the
  diagonal in and out: values at 1e-5 and gradients at 1e-6 in float32,
  1e-8 in float64, against the JAX function. Under ``jax.enable_x64`` the
  JAX package's distance gram still asks for a float32 result
  (``preferred_element_type``), which rounds a squared distance by
  ~|gram|·6e-8: ~2e-9 here (measured up to 3.8e-9 on a gradient). The
  port's float64 blocks equal its dense float64 form to 1e-12;
- its memory: the forward saves under 4 · block · n · 4 bytes for the
  backward, where the dense form saves more than n² · 4;
- one COSNE step from the JAX package's pre-loop state (entropic affinity,
  kNN indices, PCA-expmap init): the loss at 1e-5 relative, the gradient
  and the RiemannianAdam step at 1e-5 absolute (float32); in float64 the
  loss and gradient at 1e-8 (the float32 gram above) and the step at 1e-6:
  the first Adam step divides each component by its own magnitude, so a
  gradient of ~1e-4 that the gram moves by ~1e-9 moves the step by ~1e-7
  (measured 1.3e-7);
- 20 steps of the loop against the JAX package's: 1e-5 absolute;
- a two-moons fit: inside the ball and above ``TestCOSNE``'s silhouette
  floor (0.15).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

from _torch_threads import one_torch_thread, warm_worker_threads  # noqa: F401
from torchdr_tpu.models.neighbor.cosne import COSNE as JaxCOSNE
from torchdr_tpu.ops.reduce import pairwise_logkernel_rowlse_autodiff as jax_rowlse
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch import COSNE
from torchdr_tpu_torch.eval import silhouette_score
from torchdr_tpu_torch.ops.metrics import pairwise_block
from torchdr_tpu_torch.ops.reduce import pairwise_logkernel_rowlse_autodiff
from torchdr_tpu_torch.utils.interop import load_reference_state
from torchdr_tpu_torch.utils.optim import make_optimizer

GAMMA = 2.0


def _ball(n, seed, d=2):
    """n points inside the ball, as tests/test_ops.py's remat test makes them."""
    Z = np.random.default_rng(seed).normal(size=(n, d)) * 0.2
    return Z / np.maximum(1.0, np.linalg.norm(Z, axis=1, keepdims=True) * 1.2)


def _port_logk(D):
    return math.log(GAMMA) - torch.log(D + GAMMA**2)


def _jax_logk(D):
    return jnp.log(GAMMA) - jnp.log(D + GAMMA**2)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("exclude_diag", [True, False], ids=["no_diag", "diag"])
def test_autodiff_rowlse_value_and_gradient_match_jax(exclude_diag, x64):
    dtype = np.float64 if x64 else np.float32
    Z = _ball(301, 0).astype(dtype)
    with jax.enable_x64(x64):
        def f(z):
            return jax_rowlse(z, _jax_logk, "sqhyperbolic", exclude_diag, 64)

        want = np.asarray(f(jnp.asarray(Z)))
        want_g = np.asarray(jax.grad(lambda z: logsumexp(f(z)))(jnp.asarray(Z)))
    Zt = torch.from_numpy(Z).requires_grad_(True)
    got = pairwise_logkernel_rowlse_autodiff(Zt, _port_logk, "sqhyperbolic", exclude_diag, 64)
    (got_g,) = torch.autograd.grad(torch.logsumexp(got, 0), Zt)
    assert got.shape == (301,) and got.dtype == Zt.dtype
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-8 if x64 else 1e-5, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=1e-8 if x64 else 1e-6, rtol=0)


def test_autodiff_rowlse_equals_the_dense_form():
    """The blocks give the dense row log-sum and its gradient (float64)."""
    Z = torch.from_numpy(_ball(301, 1)).requires_grad_(True)
    n = Z.shape[0]
    dense = torch.logsumexp(
        _port_logk(pairwise_block(Z, Z, "sqhyperbolic")).masked_fill(
            torch.eye(n, dtype=torch.bool), float("-inf")), 1)
    blocks = pairwise_logkernel_rowlse_autodiff(Z, _port_logk, "sqhyperbolic", True, 64)
    g1 = torch.autograd.grad(torch.logsumexp(dense, 0), Z)[0]
    g2 = torch.autograd.grad(torch.logsumexp(blocks, 0), Z)[0]
    assert torch.allclose(blocks, dense, atol=1e-12, rtol=0)
    assert torch.allclose(g1, g2, atol=1e-12, rtol=0)


def _saved_bytes(fn, Z):
    """Bytes autograd saves for the backward while ``fn(Z)`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    Zg = Z.detach().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = torch.logsumexp(fn(Zg), 0)
    (g,) = torch.autograd.grad(out, Zg)
    assert torch.isfinite(g).all()
    return total[0]


def test_autodiff_rowlse_saves_o_block_times_n_bytes():
    n, block = 1000, 64
    Z = torch.from_numpy(_ball(n, 2).astype(np.float32))
    tiles = _saved_bytes(
        lambda z: pairwise_logkernel_rowlse_autodiff(z, _port_logk, "sqhyperbolic", True, block), Z
    )
    dense = _saved_bytes(
        lambda z: torch.logsumexp(_port_logk(pairwise_block(z, z, "sqhyperbolic")).masked_fill(
            torch.eye(n, dtype=torch.bool), float("-inf")), 1), Z)
    assert dense > n * n * 4
    assert tiles < 4 * block * n * 4


def _moons(n=100):
    from sklearn.datasets import make_moons

    X, y = make_moons(n_samples=n, noise=0.05, random_state=0)
    return X.astype(np.float32), y


def _pre_loop_state(kw):
    X, _ = _moons()
    Xj = jnp.asarray(X)
    jm = JaxCOSNE(**kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = None
    jm._compute_input_affinity(Xj)
    jm.on_affinity_computation_end()
    arrays = {
        "affinity_in": np.asarray(jm.affinity_in_),
        "NN_indices": np.asarray(jm.NN_indices_),
        "init_embedding": np.array(jm._init_embedding(Xj)),
    }
    tm = COSNE(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(torch.from_numpy(X)), arrays


def test_pca_expmap_init_matches_jax():
    X, _ = _moons()
    jm = JaxCOSNE(perplexity=15)
    jm.n_samples_in_ = X.shape[0]
    want = np.asarray(jm._init_embedding(jnp.asarray(X)))
    got = COSNE(perplexity=15, device="cpu")._init_embedding(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.linalg.norm(got, axis=1).max() < 1.0


@pytest.mark.parametrize("it", [0, 7])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_one_step_matches_jax(it, x64):
    """Loss, gradient and the RiemannianAdam step from the same state: the
    init at step 0, a random point of the ball with random moments at 7."""
    kw = dict(perplexity=15, max_iter=30, random_state=0)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(kw)
    n = arrays["init_embedding"].shape[0]
    rng = np.random.default_rng(it)
    if it == 0:
        Z = arrays["init_embedding"]
        m, v = np.zeros((n, 2), np.float32), np.zeros((n, 1), np.float32)
    else:
        Z = _ball(n, it).astype(np.float32)
        m = (1e-3 * rng.normal(size=(n, 2))).astype(np.float32)
        v = (1e-4 * rng.uniform(size=(n, 1))).astype(np.float32)
    dt = np.float64 if x64 else np.float32
    coeff, lr_t, hyper = tm._make_schedule()(it)
    assert (coeff, lr_t) == (1.0, 1.0)
    with jax.enable_x64(x64):
        consts = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dt) if hasattr(a, "dtype") and jnp.issubdtype(
                a.dtype, jnp.floating) else a, jconsts)
        Zj = jnp.asarray(Z, dt)
        w_loss, w_grad = jax.value_and_grad(
            lambda z: jm._loss(z, consts, {}, it, jax.random.PRNGKey(0), coeff)[0])(Zj)
        state = {"m": jnp.asarray(m, dt), "v": jnp.asarray(v, dt), "step": jnp.asarray(it)}
        w_Z, _ = jax_make_optimizer("RiemannianAdam").update(w_grad, state, Zj, lr_t, hyper)
        w_loss, w_grad, w_Z = float(w_loss), np.asarray(w_grad), np.asarray(w_Z)
    if x64:
        tconsts = {k: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
                   for k, v in tconsts.items()}
    Zt = torch.from_numpy(Z.astype(dt))
    g_loss = float(tm._loss(Zt, tconsts, {}, it, coeff)[0])
    g_grad, _ = tm._loss_gradients(Zt, tconsts, {}, it, coeff)
    tstate = {"m": torch.from_numpy(m.astype(dt)), "v": torch.from_numpy(v.astype(dt)), "step": it}
    g_Z, _ = make_optimizer("RiemannianAdam").update(g_grad, tstate, Zt, lr_t, hyper)
    tol = 1e-8 if x64 else 1e-5
    assert g_loss == pytest.approx(w_loss, rel=tol)
    np.testing.assert_allclose(g_grad.numpy(), w_grad, atol=tol, rtol=0)
    np.testing.assert_allclose(g_Z.numpy(), w_Z, atol=1e-6 if x64 else tol, rtol=0)


def test_twenty_steps_of_the_loop_match_jax():
    kw = dict(perplexity=15, max_iter=20, random_state=0)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(kw)
    Z0 = arrays["init_embedding"]
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), jconsts, {})
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, {})
    assert int(w_it) == g_it == 20
    np.testing.assert_allclose(g_Z.numpy(), np.asarray(w_Z), atol=1e-5, rtol=0)


def test_two_moons_fit_stays_in_the_ball_above_the_silhouette_floor():
    X, y = _moons()
    with one_torch_thread():
        Z = COSNE(perplexity=15, max_iter=500, lr=1e0, random_state=0,
                  device="cpu").fit_transform(X)
    assert np.isfinite(Z).all() and np.linalg.norm(Z, axis=1).max() < 1.0
    assert silhouette_score(Z, y, device="cpu") > 0.15


def test_hyperbolic_init_maps_the_given_draw_through_expmap0():
    """init="hyperbolic" maps init_scaling times a normal draw through the
    exponential map at the origin, as the JAX package does from its key."""
    from torchdr_tpu.utils.manifold import poincare_expmap0 as jax_expmap0

    X, _ = _moons()
    draw = np.random.default_rng(5).normal(size=(X.shape[0], 2)).astype(np.float32)
    model = COSNE(init="hyperbolic", init_scaling=0.7, device="cpu", random_state=0)
    got = model._init_embedding(torch.from_numpy(X), draw=torch.from_numpy(draw)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_expmap0(0.7 * jnp.asarray(draw))),
                               atol=1e-6, rtol=0)
    model.device_ = torch.device("cpu")
    model._generator_ = model._root_generator()
    drawn = model._init_embedding(torch.from_numpy(X))
    assert drawn.shape == (X.shape[0], 2) and float(drawn.norm(dim=1).max()) < 1.0
