"""The optimal-transport affinities of the PyTorch port against the JAX
package: the symmetric entropic affinity (SEA) in both solver branches,
Sinkhorn, the normalized kernels, the quadratic doubly stochastic affinity
and the L-BFGS solver the SEA's LBFGS branch calls.

The same numpy inputs go through both packages (the port with
``device="cpu"``). Tolerances:

- SEA with Adam, Sinkhorn and the quadratic affinity: 1e-5 absolute on
  n·P, the plan whose rows sum to 1 (the JAX tests' symmetry tolerance;
  measured 3.6e-7, 6.5e-9 and 1.3e-8 from the float32 JAX package and
  within float32 rounding of its float64 evaluation); the duals and
  bandwidths at 1e-5 relative;
- SEA with L-BFGS: 1e-4 absolute on P, the affinity the estimator uses
  (``tests/test_optim.py``'s LBFGS-against-Adam tolerance at the same
  n = 100). The line search's accept decisions amplify rounding: the
  float32 JAX package is 5.7e-5 from its own float64 evaluation there, and
  the port 2.8e-5 and 6.3e-5 from the float32 JAX package;
- the property checks of ``tests/test_affinity.py``,
  ``tests/test_affinity_depth.py`` and ``tests/test_optim.py`` at their
  own tolerances, on the port;
- ``lbfgs_minimize``: the JAX tests' checks on the port, and the port's
  minimizer within 1e-4 of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread, warm_worker_threads  # noqa: F401
from torchdr_tpu.affinity import entropic as jent
from torchdr_tpu.affinity.quadratic import DoublyStochasticQuadraticAffinity as JaxQuadratic
from torchdr_tpu.affinity.quadratic import _solve_quadratic_ds as _jax_quadratic_ds
from torchdr_tpu.eval import silhouette_score
from torchdr_tpu.utils.optim import lbfgs_minimize as jax_lbfgs
from torchdr_tpu_torch import (
    DoublyStochasticQuadraticAffinity,
    NormalizedGaussianAffinity,
    NormalizedStudentAffinity,
    SinkhornAffinity,
    SymmetricEntropicAffinity,
    TSNEkhorn,
)
from torchdr_tpu_torch.affinity.entropic import _log_Pse, sea_dual_value
from torchdr_tpu_torch.ops.reductions import entropy
from torchdr_tpu_torch.utils.optim import lbfgs_minimize


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """The solvers here are loops of hundreds of small ops."""
    with one_torch_thread():
        yield


def _X(n=100, d=6, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _np(P):
    return P.numpy() if isinstance(P, torch.Tensor) else np.asarray(P)


# --- SEA -------------------------------------------------------------------


def _cost64(X, zero_diag=True):
    """The affinity layer's cost in float64: centred rows, squared
    distances, the diagonal masked at 1e12 with ``zero_diag``."""
    Xc = X.astype(np.float64) - X.astype(np.float64).mean(0)
    C = ((Xc[:, None] - Xc[None]) ** 2).sum(-1)
    return C + 1e12 * np.eye(len(X)) if zero_diag else C


@pytest.mark.parametrize("zero_diag, eps_square", [(False, True), (False, False), (True, True)])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
def test_sea_adam_matches_jax(zero_diag, eps_square, x64):
    """The Adam branch, as TSNEkhorn calls it (zero_diag=False) and by
    default: the same number of steps (each stop falls on no multiple of
    the port's test interval: 343, 340, 525), and n·P, eps and mu within
    float32 rounding of the JAX package, in float32 and evaluated in
    float64 on the same input."""
    X = _X(seed=0)
    n = X.shape[0]
    kw = dict(perplexity=12, eps_square=eps_square, max_iter=600, zero_diag=zero_diag)
    ta = SymmetricEntropicAffinity(device="cpu", **kw)
    got = _np(ta(X))
    if x64:
        with jax.enable_x64(True):
            log_P, eps, mu, n_iter = jent._solve_sea(
                jnp.asarray(_cost64(X, zero_diag)), 12.0, lr=0.1, eps_square=eps_square,
                tol=1e-3, max_iter=600)
            want = np.exp(np.asarray(log_P) - np.log(n))
            assert want.dtype == np.float64
    else:
        ja = jent.SymmetricEntropicAffinity(**kw)
        want = np.asarray(ja(X))
        eps, mu, n_iter = ja.eps_, ja.mu_, ja.n_iter_
    assert ta.n_iter_ == int(n_iter) < 600
    np.testing.assert_allclose(n * got, n * want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ta.eps_), np.asarray(eps), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(ta.mu_), np.asarray(mu), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eps_square", [True, False])
def test_sea_lbfgs_matches_jax(eps_square):
    """The LBFGS branch (``tests/test_optim.py::test_sea_lbfgs_matches_adam``'s
    setting) against the JAX package's, in float32 and in float64, and
    against the port's own Adam branch, at that test's 1e-4."""
    X = _X()
    kw = dict(perplexity=12, optimizer="LBFGS", lr=0.5, max_iter=300, eps_square=eps_square)
    got = _np(SymmetricEntropicAffinity(device="cpu", **kw)(X))
    np.testing.assert_allclose(got, np.asarray(jent.SymmetricEntropicAffinity(**kw)(X)),
                               atol=1e-4, rtol=0)
    with jax.enable_x64(True):
        log_P = jent._solve_sea(jnp.asarray(_cost64(X)), 12.0, lr=0.5, eps_square=eps_square,
                                tol=1e-3, max_iter=300, optimizer="LBFGS")[0]
        want64 = np.exp(np.asarray(log_P) - np.log(X.shape[0]))
    np.testing.assert_allclose(got, want64, atol=1e-4, rtol=0)
    adam = _np(SymmetricEntropicAffinity(perplexity=12, max_iter=800, device="cpu")(X))
    assert np.max(np.abs(np.exp(adam) - np.exp(got))) < 1e-4


def test_sea_marginals_and_entropy():
    """``tests/test_affinity.py::TestSEA`` on the port."""
    X = np.random.default_rng(0).normal(size=(120, 10)).astype(np.float32)
    P = _np(SymmetricEntropicAffinity(perplexity=20, lr=1e-1, max_iter=800, device="cpu")(X))
    P = P * X.shape[0]
    assert np.abs(P - P.T).max() < 1e-5
    assert np.abs(P.sum(1) - 1.0).max() < 5e-3
    H = -np.sum(P * (np.log(P + 1e-30) - 1.0), axis=1)
    assert np.abs(H - (np.log(20) + 1)).max() < 0.2


def test_sea_eps_square_variants_agree():
    """``tests/test_affinity_depth.py::TestSolverKnobs`` on the port."""
    X = np.random.default_rng(0).normal(size=(120, 10)).astype(np.float32)
    P1 = _np(SymmetricEntropicAffinity(perplexity=12, eps_square=True, max_iter=600,
                                       device="cpu")(X))
    P2 = _np(SymmetricEntropicAffinity(perplexity=12, eps_square=False, max_iter=1500, lr=5e-2,
                                       device="cpu")(X))
    assert np.abs(P1 - P2).max() < 1e-1 * P1.max()


def test_sea_lbfgs_hits_entropy_target():
    """``tests/test_optim.py::test_sea_lbfgs_hits_entropy_target`` on the port."""
    X = np.random.default_rng(7).normal(size=(80, 5)).astype(np.float32)
    aff = SymmetricEntropicAffinity(perplexity=10, optimizer="LBFGS", max_iter=200, device="cpu")
    log_P = aff(X, log=True) + np.log(80)
    H = entropy(log_P, log=True).numpy()
    assert np.abs(H - (np.log(10.0) + 1.0)).max() < 0.05


@pytest.mark.parametrize("eps_square", [True, False])
def test_sea_dual_value_envelope_identity(eps_square):
    """Autograd of the port's dual objective is the first-order dual
    gradient of the Adam branch, and the objective is the JAX package's
    (``tests/test_optim.py``'s 2e-3)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(40, 4)).astype(np.float32)
    C = ((X[:, None] - X[None]) ** 2).sum(-1)
    eps = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    mu = rng.normal(size=40).astype(np.float32)
    target = float(np.log(np.float32(12.0)) + 1.0)
    e, m = torch.tensor(eps, requires_grad=True), torch.tensor(mu, requires_grad=True)
    val = sea_dual_value(torch.from_numpy(C), e, m, eps_square, target)
    g_eps, g_mu = torch.autograd.grad(val, (e, m))
    want = jent.sea_dual_value(jnp.asarray(C), jnp.asarray(eps), jnp.asarray(mu), eps_square,
                               target)
    np.testing.assert_allclose(float(val), float(want), rtol=1e-5)
    log_P = _log_Pse(torch.from_numpy(C), torch.from_numpy(eps), torch.from_numpy(mu), eps_square)
    ref_eps = entropy(log_P, log=True) - target
    if eps_square:
        ref_eps = 2.0 * torch.from_numpy(eps) * ref_eps
    ref_mu = torch.exp(log_P).sum(1) - 1.0
    np.testing.assert_allclose(g_eps.numpy(), ref_eps.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(g_mu.numpy(), ref_mu.numpy(), rtol=2e-3, atol=2e-3)


# --- Sinkhorn ----------------------------------------------------------------


@pytest.mark.parametrize("base_kernel", ["gaussian", "student"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
def test_sinkhorn_matches_jax(base_kernel, x64):
    """To convergence (tol 1e-5, stopping at an iteration that is no
    multiple of the port's test interval): n·P and the dual."""
    X = _X()
    ja = jent.SinkhornAffinity(eps=1.0, base_kernel=base_kernel)
    if x64:
        with jax.enable_x64(True):
            want = np.exp(np.asarray(ja.from_cost(jnp.asarray(_cost64(X)))))
            assert want.dtype == np.float64
    else:
        want = np.asarray(ja(X))
    ta = SinkhornAffinity(eps=1.0, base_kernel=base_kernel, device="cpu")
    got = _np(ta(X))
    n = X.shape[0]
    np.testing.assert_allclose(n * got, n * want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ta.dual_), np.asarray(ja.dual_), rtol=1e-5, atol=1e-5)
    assert np.abs(n * got.sum(1) - 1.0).max() < 1e-3  # tests/test_affinity.py::TestSinkhorn
    assert np.abs(n * (got - got.T)).max() < 1e-5


@pytest.mark.parametrize("max_iter", [5, 13])
def test_sinkhorn_warm_start_matches_jax(max_iter):
    """A warm-started dual and a fixed budget, as TSNEkhorn's inner Q runs
    (5 steps, no host read), and one that ends mid-interval."""
    X = _X(seed=2)
    C = ((X[:, None] - X[None]) ** 2).sum(-1).astype(np.float32)
    dual0 = np.random.default_rng(3).normal(scale=0.5, size=100).astype(np.float32)
    kw = dict(eps=1.0, base_kernel="student", max_iter=max_iter, tol=1e-5)
    ja = jent.SinkhornAffinity(**kw)
    want = np.asarray(ja.from_cost(jnp.asarray(C), init_dual=jnp.asarray(dual0)))
    ta = SinkhornAffinity(device="cpu", **kw)
    got = ta.from_cost(torch.from_numpy(C), init_dual=torch.from_numpy(dual0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta.dual_.numpy(), np.asarray(ja.dual_), rtol=1e-5, atol=1e-5)


def test_sinkhorn_with_grad_matches_jax():
    """``with_grad=True`` unrolls 5 differentiable steps: the gradient of a
    weighted sum of log P with respect to the cost, against ``jax.grad``."""
    X = _X(n=60, seed=4)
    C = ((X[:, None] - X[None]) ** 2).sum(-1).astype(np.float32)
    W = np.random.default_rng(5).random((60, 60)).astype(np.float32) / 3600
    kw = dict(eps=1.0, base_kernel="student", max_iter=5, with_grad=True)
    ja = jent.SinkhornAffinity(**kw)
    want = np.asarray(jax.grad(lambda c: jnp.sum(jnp.asarray(W) * ja.from_cost(c)))(jnp.asarray(C)))
    Ct = torch.from_numpy(C).requires_grad_(True)
    loss = torch.sum(torch.from_numpy(W) * SinkhornAffinity(device="cpu", **kw).from_cost(Ct))
    (got,) = torch.autograd.grad(loss, Ct)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-8)


def test_sinkhorn_eps_monotone_entropy():
    """``tests/test_affinity_depth.py::TestSolverKnobs`` on the port."""
    X = np.random.default_rng(0).normal(size=(120, 10)).astype(np.float32)

    def ent(P):
        P = P / P.sum()
        return -np.sum(P * np.log(P + 1e-30))

    assert ent(_np(SinkhornAffinity(eps=3.0, device="cpu")(X))) > ent(
        _np(SinkhornAffinity(eps=0.3, device="cpu")(X)))


# --- Normalized kernels --------------------------------------------------------


@pytest.mark.parametrize("cls, kw", [
    ("Gaussian", dict(normalization_dim=(0, 1))),
    ("Gaussian", dict(normalization_dim=1)),
    ("Gaussian", dict(normalization_dim=0, sigma=0.5)),
    ("Gaussian", dict(normalization_dim=None, sigma=2.0)),
    ("Student", dict(normalization_dim=(0, 1))),
    ("Student", dict(normalization_dim=1, degrees_of_freedom=3.0)),
])
def test_normalized_affinities_match_jax(cls, kw):
    X = _X(n=120, d=10, seed=0)
    ja = getattr(jent, f"Normalized{cls}Affinity")(**kw)
    ta = {"Gaussian": NormalizedGaussianAffinity,
          "Student": NormalizedStudentAffinity}[cls](device="cpu", **kw)
    want = np.asarray(ja(X, log=True))
    got = _np(ta(X, log=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    P = _np(ta(X))
    dim = kw["normalization_dim"]  # tests/test_affinity.py::TestNormalized
    if dim == (0, 1):
        assert abs(P.sum() - 1.0) < 1e-4
    elif dim == 1:
        assert np.abs(P.sum(1) * X.shape[0] - 1.0).max() < 1e-4
    elif dim is None:
        assert P.max() <= 1.0 + 1e-6


# --- Quadratic ------------------------------------------------------------------


@pytest.mark.parametrize("base_kernel", ["gaussian", "student"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
def test_quadratic_matches_jax(base_kernel, x64):
    """n·P and the dual; then ``tests/test_affinity.py::TestQuadratic``'s
    checks on the port."""
    X = _X(n=60, seed=0)
    kw = dict(eps=1.0, lr=1e-1, max_iter=2000, base_kernel=base_kernel)
    if x64:
        C = _cost64(X)
        if base_kernel == "student":
            C = np.log1p(C)
        with jax.enable_x64(True):
            want, dual, _ = _jax_quadratic_ds(jnp.asarray(C), 1.0, 1e-1, 1e-5, 2000)
            want, dual = np.asarray(want), np.asarray(dual)
            assert want.dtype == np.float64
    else:
        ja = JaxQuadratic(**kw)
        want, dual = np.asarray(ja(X)), np.asarray(ja.dual_)
    ta = DoublyStochasticQuadraticAffinity(device="cpu", **kw)
    P = _np(ta(X)) * 60
    np.testing.assert_allclose(P, want * 60, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ta.dual_), dual, rtol=1e-5, atol=1e-5)
    assert ta.n_iter_ < 2000
    assert np.abs(P - P.T).max() < 1e-5
    assert np.abs(P.sum(1) - 1.0).max() < 5e-2
    assert (P >= 0).all()


def test_quadratic_sparser_than_sinkhorn():
    """``tests/test_affinity_depth.py::TestSolverKnobs`` on the port."""
    X = np.random.default_rng(0).normal(size=(120, 10)).astype(np.float32)
    Pq = _np(DoublyStochasticQuadraticAffinity(eps=1.0, max_iter=500, device="cpu")(X))
    Ps = _np(SinkhornAffinity(eps=1.0, device="cpu")(X))
    assert np.mean(Pq <= 1e-12) > np.mean(Ps <= 1e-12)


# --- lbfgs_minimize ---------------------------------------------------------------


def _autograd(f):
    def vag(params):
        ps = tuple(p.detach().requires_grad_(True) for p in params) if isinstance(
            params, tuple) else params.detach().requires_grad_(True)
        val = f(ps)
        g = torch.autograd.grad(val, ps)
        return val.detach(), g if isinstance(params, tuple) else g[0]
    return vag


def test_lbfgs_rosenbrock_pytree():
    def f(p):
        x, y = p
        return (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2

    (x, y), fv, k = lbfgs_minimize(_autograd(f), (torch.tensor(-1.2), torch.tensor(1.0)),
                                   max_iter=200, tol=1e-5)
    assert abs(float(x) - 1.0) < 1e-2 and abs(float(y) - 1.0) < 1e-2
    assert float(fv) < 1e-4
    assert k < 200
    (jx, jy), _, jk = jax_lbfgs(jax.value_and_grad(f), (jnp.asarray(-1.2), jnp.asarray(1.0)),
                                max_iter=200, tol=1e-5)
    assert abs(float(x) - float(jx)) < 1e-4 and abs(float(y) - float(jy)) < 1e-4


def _quadratic(dtype):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 40))
    A = (A @ A.T / 40 + np.eye(40)).astype(dtype)
    return A, rng.normal(size=40).astype(dtype)


def test_lbfgs_quadratic_fast_and_monotone():
    """``tests/test_optim.py``'s quadratic and its checks, evaluated in
    float64, where the port's minimizer is the JAX package's within 1e-6.
    In float32 the solve stops where f stops changing at float32
    resolution (the relative-change test, 1e-12 · |f|): at f ≈ -18.34
    (ulp 1.9e-6) that is a residual of ~1e-3, the check's own bound, and
    which side of it a run ends on is rounding (ROADMAP, "Quirks of the
    reference"): :func:`test_lbfgs_float32_iterates_match_jax` holds the
    float32 iterates up to that point."""
    A, b = _quadratic(np.float64)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def f(x):
        return 0.5 * x @ At @ x - bt @ x

    x0 = torch.zeros(40, dtype=torch.float64)
    x, fv, k = lbfgs_minimize(_autograd(f), x0, max_iter=100, tol=1e-5)
    assert float(torch.linalg.norm(At @ x - bt)) < 1e-3
    assert float(fv) <= float(f(x0))
    assert k <= 60
    with jax.enable_x64(True):
        jx, _, jk = jax_lbfgs(jax.value_and_grad(lambda v: 0.5 * v @ jnp.asarray(A) @ v
                                                 - jnp.asarray(b) @ v),
                              jnp.zeros(40, jnp.float64), max_iter=100, tol=1e-5)
        jx = np.asarray(jx)
    assert k == int(jk)
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-6, rtol=0)


@pytest.mark.parametrize("max_iter", [1, 5, 9])
def test_lbfgs_float32_iterates_match_jax(max_iter):
    """The float32 solve of the same quadratic, stopped after 1, 5 and 9
    iterations (before rounding decides its end): the port's iterate within
    1e-5 of the JAX package's (measured 7.2e-7)."""
    A, b = _quadratic(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x, _, k = lbfgs_minimize(_autograd(lambda v: 0.5 * v @ At @ v - bt @ v), torch.zeros(40),
                             max_iter=max_iter, tol=1e-5)
    jx, _, jk = jax_lbfgs(jax.value_and_grad(lambda v: 0.5 * v @ jnp.asarray(A) @ v
                                             - jnp.asarray(b) @ v), jnp.zeros(40),
                          max_iter=max_iter, tol=1e-5)
    assert k == int(jk) == max_iter
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5, rtol=0)


def test_lbfgs_line_search_survives_steep_start():
    def f(x):
        return torch.sum(torch.cosh(5.0 * x))

    x, fv, _ = lbfgs_minimize(_autograd(f), torch.full((4,), 2.0), max_iter=100, tol=1e-5)
    assert bool(torch.isfinite(fv))
    assert float(torch.max(torch.abs(x))) < 1e-3


# --- a fit and the device ----------------------------------------------------------


def test_moons_fit_through_sea_and_sinkhorn(toy_moons):
    """TSNEkhorn's 300 steps over the SEA input affinity and the Sinkhorn
    output affinity (min_grad_norm lowered: at the default 1e-4 the fit
    stops after its first step, in the JAX package too), at the quality
    floor of ``tests/test_neighbor_embedding.py``."""
    X, y = toy_moons
    model = TSNEkhorn(perplexity=15, max_iter=300, lr=1e-1, min_grad_norm=1e-7, random_state=0,
                      device="cpu")
    Z = model.fit_transform(X)
    assert model.n_iter_ == 300 and Z.shape == (100, 2) and np.isfinite(Z).all()
    assert float(silhouette_score(Z, y)) > 0.15


@pytest.mark.parametrize("make", [
    lambda: SymmetricEntropicAffinity(perplexity=5),
    lambda: SinkhornAffinity(),
    lambda: NormalizedGaussianAffinity(),
    lambda: NormalizedStudentAffinity(),
    lambda: DoublyStochasticQuadraticAffinity(),
])
def test_device_auto_without_cuda_raises(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()(_X(n=20))
