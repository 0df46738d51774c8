"""PHATE of the PyTorch port against the JAX package.

Both packages start from the JAX package's pre-loop state (its negative
potential distances and its PCA init), carried into the port by
``load_reference_state``. Tolerances:

- one loss and gradient (the normalized stress), at the PCA init and at a
  spread embedding: the loss at 1e-5 relative, the gradient at 1e-5 of its
  largest entry, against the JAX package in float32 and evaluated in
  float64 on the same inputs;
- a short run of the loop (Adam, 20 steps): 1e-4 of the embedding's
  largest entry (Adam's normalized steps carry the float32 rounding of the
  gradient's small entries);
- the two-moons fit of ``tests/test_spectral.py``: silhouette above 0.15
  and within 0.1 of the JAX fit's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.eval import silhouette_score
from torchdr_tpu.models.spectral.phate import PHATE as JaxPHATE
from torchdr_tpu_torch import PHATE
from torchdr_tpu_torch.utils.interop import load_reference_state


def _blobs(n=120, d=8, n_clusters=3, seed=0, scale=5.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32), labels


def _pre_loop_state(kw, seed=2):
    X, _ = _blobs(seed=seed)
    Xj = jnp.asarray(X)
    jm = JaxPHATE(**kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = None
    jm._compute_input_affinity(Xj)
    arrays = {
        "affinity_in": np.asarray(jm.affinity_in_),
        "NN_indices": None,
        "init_embedding": np.array(jm._init_embedding(Xj)),
    }
    tm = PHATE(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(None), arrays


@pytest.mark.parametrize("start", ["init", "spread"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
def test_one_loss_and_gradient_match_jax(start, x64):
    kw = dict(k=5, t=20, max_iter=10, random_state=0)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(kw)
    n = arrays["init_embedding"].shape[0]
    assert tconsts["P"].shape == (n, n)
    Z = arrays["init_embedding"] if start == "init" else (
        30.0 * np.random.default_rng(3).normal(size=(n, 2))).astype(np.float32)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        consts = {**jconsts, "P": jnp.asarray(jconsts["P"], dt)}
        (w_loss, _), w_grad = jax.value_and_grad(
            lambda v: jm._loss(v, consts, {}, 0, key, 1.0), has_aux=True)(jnp.asarray(Z, dt))
        w_loss, w_grad = float(w_loss), np.asarray(w_grad)
    Zg = torch.from_numpy(Z.copy()).requires_grad_(True)
    loss, _ = tm._loss(Zg, tconsts, {}, 0, 1.0)
    (grad,) = torch.autograd.grad(loss, Zg)
    np.testing.assert_allclose(float(loss.detach()), w_loss, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), w_grad, atol=1e-5 * np.abs(w_grad).max(), rtol=0)


def test_short_run_of_the_loop_matches_jax():
    """``_optimize`` of both packages over 20 Adam steps from the same
    pre-loop state and a spread start."""
    kw = dict(k=5, t=20, max_iter=20, random_state=0)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(kw, seed=4)
    n = arrays["init_embedding"].shape[0]
    Z0 = (30.0 * np.random.default_rng(1).normal(size=(n, 2))).astype(np.float32)
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), jconsts, jm._init_carry(jconsts))
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, tm._init_carry(tconsts))
    assert int(w_it) == g_it == 20
    w_Z = np.asarray(w_Z)
    np.testing.assert_allclose(g_Z.numpy(), w_Z, atol=1e-4 * np.abs(w_Z).max(), rtol=0)


def test_pre_loop_state_matches_jax():
    """The port's own affinity and init from the same rows: the negative
    potential distances at 1e-3 of the largest (``tests/test_torch_knn_affinity.py``
    says why) and the PCA init at 1e-5 of its largest entry, up to sign."""
    kw = dict(k=5, t=20, random_state=0)
    X, _ = _blobs(seed=2)
    jm, _, tm, _, arrays = _pre_loop_state(kw)
    P = PHATE(device="cpu", **kw).affinity_in(X).numpy()
    want = arrays["affinity_in"]
    np.testing.assert_allclose(P, want, atol=1e-3 * np.abs(want).max(), rtol=0)
    tm.device_ = torch.device("cpu")
    Z0 = tm._init_embedding(torch.from_numpy(X)).numpy()
    W0 = arrays["init_embedding"]
    signs = np.sign(np.sum(Z0 * W0, axis=0))
    np.testing.assert_allclose(Z0 * signs, W0, atol=1e-5 * np.abs(W0).max(), rtol=0)


@pytest.mark.parametrize("t", [50, 100])
def test_moons_quality(toy_moons, t):
    """``tests/test_spectral.py::TestPHATE::test_quality`` on the port (and at
    the default t = 100): silhouette above 0.15 and within 0.1 of the JAX
    package's fit."""
    X, y = toy_moons
    kw = dict(k=5, t=t, max_iter=300, random_state=0)
    Z = PHATE(device="cpu", **kw).fit_transform(X)
    assert Z.shape == (100, 2) and np.isfinite(Z).all()
    s_port = float(silhouette_score(Z, y))
    assert s_port > 0.15
    s_jax = float(silhouette_score(np.asarray(JaxPHATE(**kw).fit_transform(X)), y))
    assert abs(s_port - s_jax) <= 0.1


def test_device_auto_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    X, _ = _blobs(n=60, seed=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PHATE(max_iter=5).fit_transform(X)


def test_params_follow_the_jax_defaults():
    jm, tm = JaxPHATE(), PHATE(device="cpu")
    for name in ("k", "t", "alpha", "optimizer", "optimizer_kwargs", "lr", "scheduler",
                 "min_grad_norm", "max_iter", "init", "init_scaling", "check_interval",
                 "metric_in", "n_components"):
        assert getattr(tm, name) == getattr(jm, name), name
    for name in ("k", "t", "alpha", "metric", "zero_diag"):
        assert getattr(tm.affinity_in, name) == getattr(jm.affinity_in, name), name
