"""The port's generic matcher against the JAX package's: the loss between a
precomputed P and ``affinity_out(Z)``, the six optimizers and the
schedulers in its loop, and ``max_iters_per_dispatch``.

The same numpy P (a random symmetric positive matrix normalized to sum 1,
as ``tests/test_estimators.py`` makes it) goes through both packages.
Tolerances:

- one loss and its gradient, for the square loss and the cross-entropy
  (in the log domain for a ``LogAffinity``, the JAX package's defaults),
  with the normalized Student and Gaussian output affinities: the loss at
  1e-5 relative, the gradient at 1e-5 of its largest entry, against the
  JAX package in float32 and evaluated in float64 on the same inputs;
- ten steps of the loop from the same start, for every optimizer and
  every scheduler: 1e-5 absolute. The problem is the normalized Gaussian
  output affinity from a PCA start at std 1, where a perturbation of 1e-7
  of the start moves the JAX package's own LBFGS run by 4.6e-6; with the
  Student affinity from std 0.1 it moves it by 6.6e-5, so that problem
  cannot hold two float32 implementations to 1e-5;
- ``max_iters_per_dispatch``: the same embedding as ``None``, bit for bit,
  with and without an early stop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu import AffinityMatcher as JaxAffinityMatcher
from torchdr_tpu.affinity.entropic import NormalizedGaussianAffinity as JaxNGA
from torchdr_tpu.affinity.entropic import NormalizedStudentAffinity as JaxNSA
from torchdr_tpu_torch import (
    UMAP,
    AffinityMatcher,
    NormalizedGaussianAffinity,
    NormalizedStudentAffinity,
)

AFFINITIES = {"student": (JaxNSA, NormalizedStudentAffinity),
              "gaussian": (JaxNGA, NormalizedGaussianAffinity)}
SCHEDULERS = {
    None: None,
    "LinearLR": {"start_factor": 1.0, "end_factor": 0.0},
    "ExponentialLR": {"gamma": 0.9},
    "CosineAnnealingLR": {"eta_min_ratio": 0.1},
    "ConstantLR": {"factor": 0.5, "total_iters": 4},
}


def _P(n=60, seed=0):
    P = np.abs(np.random.default_rng(seed).normal(size=(n, n))).astype(np.float32)
    return (P + P.T) / (P + P.T).sum()


def _pair(affinity="student", **kw):
    jax_aff, port_aff = AFFINITIES[affinity]
    jm = JaxAffinityMatcher("precomputed", affinity_out=jax_aff(), random_state=0, **kw)
    tm = AffinityMatcher("precomputed", affinity_out=port_aff(device="cpu"), random_state=0,
                         device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
@pytest.mark.parametrize("affinity", ["student", "gaussian"])
@pytest.mark.parametrize("loss_fn", ["square_loss", "cross_entropy_loss"])
def test_generic_loss_and_gradient_match_jax(loss_fn, affinity, x64):
    P = _P()
    Z = np.random.default_rng(1).normal(size=(60, 2)).astype(np.float32)
    jm, tm = _pair(affinity, loss_fn=loss_fn)
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        consts = {"P": jnp.asarray(P, dt), "n": 60}
        w_loss, w_grad = jax.value_and_grad(
            lambda z: jm._loss(z, consts, {}, 0, jax.random.PRNGKey(0), 1.0)[0]
        )(jnp.asarray(Z, dt))
        w_loss, w_grad = float(w_loss), np.asarray(w_grad)
    tconsts = {"P": torch.from_numpy(P), "n": 60}
    g_loss = float(tm._loss(torch.from_numpy(Z), tconsts, {}, 0, 1.0)[0])
    g_grad, _ = tm._loss_gradients(torch.from_numpy(Z), tconsts, {}, 0, 1.0)
    assert g_loss == pytest.approx(w_loss, rel=1e-5)
    np.testing.assert_allclose(g_grad.numpy(), w_grad, atol=1e-5 * np.abs(w_grad).max(), rtol=0)


def _loops(jm, tm, P):
    """``_optimize`` of both packages from the JAX package's PCA start."""
    Pj = jnp.asarray(P)
    jm.n_samples_in_ = tm.n_samples_in_ = P.shape[0]
    jm._fit_mesh_ = None
    Z0 = np.array(jm._init_embedding(Pj))
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), {"P": Pj, "n": P.shape[0]}, {})
    tm.device_ = torch.device("cpu")
    tm._generator_ = tm._root_generator()
    tm._fit_mesh_ = None
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0), {"P": torch.from_numpy(P),
                                                       "n": P.shape[0]}, {})
    assert int(w_it) == g_it
    return g_Z.numpy(), np.asarray(w_Z)


@pytest.mark.parametrize("optimizer", ["SGD", "Adam", "AdamW", "NAdam", "RiemannianAdam",
                                       "LBFGS"])
def test_ten_steps_of_each_optimizer_match_jax(optimizer):
    """The cross-entropy against the normalized Gaussian affinity from the
    PCA start at std 1 (RiemannianAdam: 0.3, inside the ball)."""
    jm, tm = _pair("gaussian", loss_fn="cross_entropy_loss", optimizer=optimizer, lr=0.05,
                   max_iter=10, init_scaling=0.3 if optimizer == "RiemannianAdam" else 1.0)
    got, want = _loops(jm, tm, _P())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scheduler", list(SCHEDULERS), ids=str)
def test_ten_steps_under_each_scheduler_match_jax(scheduler):
    jm, tm = _pair(loss_fn="square_loss", optimizer="Adam", lr=0.05, max_iter=10,
                   scheduler=scheduler, scheduler_kwargs=SCHEDULERS[scheduler])
    got, want = _loops(jm, tm, _P(seed=2))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_precomputed_fit_matches_jax():
    """tests/test_estimators.py's precomputed fit, through ``fit_transform``
    in both packages (PCA of P as the start, no row dedup), on the
    conditioned problem of the optimizer test. P is a Gaussian kernel of
    three blobs: the PCA start of a random P is ill-posed (its top singular
    values are 4 % apart), that of clustered rows is not."""
    rng = np.random.default_rng(3)
    Y = rng.normal(scale=4.0, size=(3, 5))[np.arange(60) % 3] + rng.normal(size=(60, 5))
    P = np.exp(-((Y[:, None] - Y[None]) ** 2).sum(-1) / 10.0)
    P = (P / P.sum()).astype(np.float32)
    jm, tm = _pair("gaussian", loss_fn="cross_entropy_loss", lr=0.05, max_iter=10,
                   init_scaling=1.0)
    want = np.asarray(jm.fit_transform(P))
    got = tm.fit_transform(P)
    assert got.shape == (60, 2) and tm.process_duplicates is False
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_precomputed_must_be_square_and_nonnegative():
    _, tm = _pair(max_iter=5)
    with pytest.raises(ValueError, match="n_samples"):
        tm.fit_transform(np.ones((10, 4), np.float32))
    with pytest.raises(ValueError, match="negative"):
        tm.fit_transform(-np.ones((10, 10), np.float32))


def test_affinity_out_must_be_an_affinity_and_set():
    with pytest.raises(ValueError, match="affinity_out must be an Affinity"):
        AffinityMatcher("precomputed", affinity_out="student", device="cpu")
    m = AffinityMatcher("precomputed", device="cpu", max_iter=3)
    with pytest.raises(ValueError, match="affinity_out is not set"):
        m.fit_transform(_P())


@pytest.mark.parametrize("min_grad_norm", [1e-7, 1e3], ids=["runs_out", "stops_early"])
def test_max_iters_per_dispatch_changes_nothing(min_grad_norm):
    """Segments of 7 and 3 steps give the embedding and the step count of
    one segment, bit for bit; with a large ``min_grad_norm`` the fit stops
    at its first check (step 0) either way."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(80, 5)).astype(np.float32)
    fits = []
    for seg in (None, 7, 3):
        m = UMAP(n_neighbors=8, max_iter=40, check_interval=10, random_state=0, device="cpu",
                 min_grad_norm=min_grad_norm, max_iters_per_dispatch=seg)
        fits.append((m.fit_transform(X), m.n_iter_))
    assert fits[0][1] == (40 if min_grad_norm < 1 else 1)
    for Z, n_iter in fits[1:]:
        assert n_iter == fits[0][1] and np.array_equal(Z, fits[0][0])
