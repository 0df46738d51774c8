"""The spectral estimators of the PyTorch port against the JAX package:
``lobpcg_standard``, ``KernelPCA`` (eigh, dense LOBPCG, matrix-free LOBPCG),
``IncrementalPCA`` and ``ExactIncrementalPCA``, and the state carried across
by ``load_incremental_pca_state``.

LOBPCG's start is a random draw: the tests give the port the JAX package's
own draw (``jax.random.normal`` of its root key), so both run the same
iteration. Tolerances, each stated at its test:

- ``lobpcg_standard`` from the same start and operator: θ at 1e-5 of θ₁,
  the iteration count equal, vectors up to sign at 1e-4 (float32; 1e-9 in
  float64);
- KernelPCA: eigenvalues at 1e-5 of λ₁ against the JAX package's eigh and
  LOBPCG, and 1e-4 · max(1, λ₁) against eigh for the LOBPCG paths (the JAX
  package's own tolerance, ``tests/test_spectral.py``); embeddings up to
  sign at 1e-3 of their largest entry;
- IncrementalPCA: the host statistics equal, components up to sign and
  singular values at 1e-5, projections at 1e-5 of their largest entry;
- ExactIncrementalPCA: components up to sign and projections at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.affinity import NormalizedGaussianAffinity as JaxGaussian
from torchdr_tpu.affinity import NormalizedStudentAffinity as JaxStudent
from torchdr_tpu.affinity import SelfTuningAffinity as JaxSelfTuning
from torchdr_tpu.models.spectral import ExactIncrementalPCA as JaxExactIPCA
from torchdr_tpu.models.spectral import IncrementalPCA as JaxIPCA
from torchdr_tpu.models.spectral import KernelPCA as JaxKernelPCA
from torchdr_tpu_torch import (
    ExactIncrementalPCA,
    IncrementalPCA,
    KernelPCA,
    NormalizedGaussianAffinity,
    NormalizedStudentAffinity,
    SelfTuningAffinity,
)
from torchdr_tpu_torch.utils.interop import load_incremental_pca_state
from torchdr_tpu_torch.utils.lobpcg import lobpcg_standard


def _blobs(n, d, seed, n_clusters=5, scale=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


def _up_to_sign(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    signs = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * signs[None, :], want, atol=atol, rtol=0)


# --- lobpcg_standard ---


def _spd(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return (A @ A.T / n + np.diag(np.linspace(0, spread, n))).astype(np.float32)


@pytest.mark.parametrize("n, k, seed", [(300, 3, 0), (200, 1, 1), (400, 4, 2)])
@pytest.mark.parametrize("form", ["matrix", "callable"])
def test_lobpcg_matches_jax(n, k, seed, form):
    """From the same start: θ at 1e-5 of θ₁, the same iteration count, the
    vectors up to sign at 1e-4 (close eigenvalues: measured 3.3e-5)."""
    from jax.experimental.sparse.linalg import lobpcg_standard as jax_lobpcg

    A = _spd(n, seed)
    X0 = np.random.default_rng(seed + 10).normal(size=(n, k)).astype(np.float32)
    Aj = jnp.asarray(A)
    wt, wX, wi = jax_lobpcg(Aj if form == "matrix" else (lambda V: Aj @ V), jnp.asarray(X0), m=200)
    At = torch.from_numpy(A)
    gt, gX, gi = lobpcg_standard(At if form == "matrix" else (lambda V: At @ V),
                                 torch.from_numpy(X0), m=200)
    assert gi == int(wi) and 0 < gi < 200
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-5 * float(wt[0]), rtol=0)
    _up_to_sign(gX.numpy(), wX, 1e-4)
    w = np.linalg.eigvalsh(A.astype(np.float64))[::-1][:k]
    np.testing.assert_allclose(gt.numpy(), w, rtol=1e-4)


def test_lobpcg_matches_jax_in_float64():
    """The same in float64 at tol 1e-10: θ at 1e-12 relative, vectors at
    1e-9. (At float64's own epsilon the stop test sits at the rounding
    floor, where the two packages' products stop 4 iterations apart.)"""
    from jax.experimental.sparse.linalg import lobpcg_standard as jax_lobpcg

    A = _spd(300, 3).astype(np.float64)
    X0 = np.random.default_rng(4).normal(size=(300, 2))
    with jax.enable_x64(True):
        wt, wX, wi = jax_lobpcg(jnp.asarray(A), jnp.asarray(X0), m=200, tol=1e-10)
        wt, wX, wi = np.asarray(wt), np.asarray(wX), int(wi)
    gt, gX, gi = lobpcg_standard(torch.from_numpy(A), torch.from_numpy(X0), m=200, tol=1e-10)
    assert gi == wi
    np.testing.assert_allclose(gt.numpy(), wt, rtol=1e-12)
    _up_to_sign(gX.numpy(), wX, 1e-9)


@pytest.mark.parametrize("sync_every", [1, 3, 8, 64])
def test_lobpcg_stop_flag_read_every_few_iterations_changes_nothing(sync_every):
    """Masking the updates after the stop condition holds gives the result
    of testing it every iteration, bit for bit, at any reading interval."""
    A = torch.from_numpy(_spd(300, 5))
    X0 = torch.from_numpy(np.random.default_rng(6).normal(size=(300, 2)).astype(np.float32))
    ref = lobpcg_standard(A, X0, sync_every=1)
    got = lobpcg_standard(A, X0, sync_every=sync_every)
    assert got[2] == ref[2]
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_lobpcg_tol_and_cap():
    """A tighter ``tol`` takes more iterations; ``m`` caps them."""
    A = torch.from_numpy(_spd(300, 7))
    X0 = torch.from_numpy(np.random.default_rng(8).normal(size=(300, 2)).astype(np.float32))
    _, _, loose = lobpcg_standard(A, X0, tol=1e-4)
    _, _, tight = lobpcg_standard(A, X0)
    assert loose < tight
    assert lobpcg_standard(A, X0, m=3)[2] == 3


def test_lobpcg_input_checks():
    """The JAX function's checks: 5k < n, and the operator's output shape."""
    X0 = torch.ones((20, 4))
    with pytest.raises(ValueError, match="search dim"):
        lobpcg_standard(torch.eye(20), X0)
    with pytest.raises(ValueError, match="must be"):
        lobpcg_standard(lambda V: V[:10], torch.ones((100, 2)))


# --- KernelPCA ---


def _jax_start(random_state, n, k):
    return np.array(jax.random.normal(jax.random.PRNGKey(random_state), (n, k), jnp.float32))


def _kpca_pair(make_aff, jmake_aff, X, **kw):
    jm = JaxKernelPCA(affinity=jmake_aff(), **kw)
    wZ = np.asarray(jm.fit_transform(X))
    tm = KernelPCA(affinity=make_aff(), device="cpu", **kw)
    return jm, wZ, tm


def _moons():
    from sklearn.datasets import make_moons

    X, y = make_moons(n_samples=100, noise=0.05, random_state=0)
    return X.astype(np.float32), y


EIGH_CASES = {
    "moons_default": (lambda: _moons()[0], lambda: NormalizedGaussianAffinity(
        normalization_dim=None, device="cpu"), lambda: JaxGaussian(normalization_dim=None), {}),
    "gaussian_sigma2": (lambda: np.random.default_rng(0).normal(size=(80, 5)).astype(np.float32),
                        lambda: NormalizedGaussianAffinity(sigma=2.0, normalization_dim=None,
                                                           zero_diag=False, device="cpu"),
                        lambda: JaxGaussian(sigma=2.0, normalization_dim=None, zero_diag=False),
                        {"n_components": 3}),
    "student_all": (lambda: _blobs(120, 8, 1), lambda: NormalizedStudentAffinity(device="cpu"),
                    lambda: JaxStudent(), {}),
    "self_tuning_nodiag": (lambda: _blobs(150, 5, 4), lambda: SelfTuningAffinity(
        normalization_dim=None, device="cpu"), lambda: JaxSelfTuning(normalization_dim=None),
        {"nodiag": True, "n_components": 3}),
}


@pytest.mark.parametrize("case", sorted(EIGH_CASES))
def test_kernel_pca_eigh_matches_jax(case):
    """``solver="eigh"`` at the JAX package's test sizes: eigenvalues at
    1e-5 of λ₁, the embedding up to sign at 1e-3 of its largest entry."""
    make_X, aff, jaff, kw = EIGH_CASES[case]
    X = make_X()
    jm, wZ, tm = _kpca_pair(aff, jaff, X, **kw)
    Z = tm.fit_transform(X)
    lam = np.asarray(jm.eigenvalues_)
    got = tm.eigenvalues_.numpy()
    assert tm.lobpcg_iterations_ is None
    # nodiag keeps the eigenvalues above 0: how many of those at the
    # rounding floor stay is the rounding's (measured 22 against 21)
    assert abs(got.shape[0] - lam.shape[0]) <= (2 if kw.get("nodiag") else 0)
    m = min(got.shape[0], lam.shape[0])
    np.testing.assert_allclose(got[:m], lam[:m], atol=1e-5 * abs(lam[0]), rtol=0)
    _up_to_sign(Z, wZ, 1e-3 * np.abs(wZ).max())


MATFREE_CASES = {
    # tests/test_spectral.py's matrix-free case: n = 2,000, several blocks
    "gaussian_2000": (lambda: _blobs(2000, 6, 2, scale=4.0), dict(
        sigma=4.0, normalization_dim=None, zero_diag=False), 3, NormalizedGaussianAffinity,
        JaxGaussian),
    "gaussian_all_300": (lambda: np.random.default_rng(3).normal(size=(300, 5)).astype(np.float32),
                         dict(sigma=3.0, normalization_dim=(0, 1)), 2, NormalizedGaussianAffinity,
                         JaxGaussian),
    "student_euclidean": (lambda: _blobs(600, 6, 5), dict(metric="euclidean",
                                                          normalization_dim=None),
                          2, NormalizedStudentAffinity, JaxStudent),
}


@pytest.mark.parametrize("case", sorted(MATFREE_CASES))
def test_kernel_pca_matrix_free_lobpcg_matches_jax(case):
    """The matrix-free operator from the JAX package's start: the same
    iteration count, eigenvalues at 1e-5 of λ₁ and eigenvectors up to sign
    at 1e-4 (measured 8e-6) against the JAX package's matrix-free LOBPCG;
    against eigh, eigenvalues at 1e-4 · max(1, λ₁) (1e-6 + 1e-3 λ₁ under a
    global (0, 1) normalization, which scales them) and the fitted embedding
    at 1e-2 in absolute value, the tolerances of ``tests/test_spectral.py``."""
    make_X, akw, k, T, J = MATFREE_CASES[case]
    X = make_X()
    jm, wZ, tm = _kpca_pair(lambda: T(device="cpu", **akw), lambda: J(**akw), X,
                            n_components=k, solver="lobpcg", random_state=0)
    assert tm._kernel_block_fn() is not None
    X0 = torch.from_numpy(_jax_start(0, X.shape[0], k))
    lam, U = tm._lobpcg_matfree(torch.from_numpy(X), tm._kernel_block_fn(), X0=X0)
    assert tm.lobpcg_iterations_ == _jax_matfree_iterations(jm, X)
    wlam = np.asarray(jm.eigenvalues_)
    np.testing.assert_allclose(lam.numpy(), wlam, atol=1e-5 * wlam[0], rtol=0)
    _up_to_sign(U.numpy(), np.asarray(jm.eigenvectors_), 1e-4)
    ref = KernelPCA(affinity=T(device="cpu", **akw), n_components=k, device="cpu")
    Z_eigh = ref.fit_transform(X)
    lam_eigh = ref.eigenvalues_[:k].numpy()
    if akw["normalization_dim"] == (0, 1):
        assert np.abs(lam.numpy() - lam_eigh).max() < 1e-6 + 1e-3 * lam_eigh[0]
    else:
        assert np.abs(lam.numpy() - lam_eigh).max() < 1e-4 * max(1.0, lam_eigh[0])
    Z = tm.fit_transform(X)  # the estimator's own draw
    assert np.abs(np.abs(Z) - np.abs(Z_eigh)).max() < 1e-2


def _jax_matfree_iterations(jm, X):
    """The JAX package's LOBPCG iteration count on its matrix-free operator
    (``lobpcg_standard`` returns it; ``_lobpcg_matfree`` drops it)."""
    import jax.experimental.sparse.linalg as jlinalg

    seen = []
    orig = jlinalg.lobpcg_standard

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(int(out[2]))
        return out

    jlinalg.lobpcg_standard = spy
    try:
        jm._lobpcg_matfree(jnp.asarray(X), jm._kernel_block_fn(X))
    finally:
        jlinalg.lobpcg_standard = orig
    return seen[0]


def test_kernel_pca_matrix_free_streams_small_blocks():
    """The operator is the same at any row block (7 rows: ragged blocks)."""
    X = _blobs(200, 4, 9)
    tm = KernelPCA(affinity=NormalizedGaussianAffinity(sigma=5.0, normalization_dim=None,
                                                       device="cpu"), device="cpu")
    W = torch.from_numpy(np.random.default_rng(1).normal(size=(200, 3)).astype(np.float32))
    kern = tm._kernel_block_fn()
    a = tm._matfree_operator(torch.from_numpy(X), kern, block=512)[0](W)
    b = tm._matfree_operator(torch.from_numpy(X), kern, block=7)[0](W)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * float(a.abs().max()), rtol=0)


def test_kernel_pca_dense_lobpcg_matches_jax():
    """An affinity with no matrix-free form (``tests/test_spectral.py``'s
    SelfTuning case) takes the dense LOBPCG: from the JAX package's start and
    the same kernel, eigenvalues at 1e-5 of λ₁ and the same iteration count;
    the fitted eigenvalues against eigh at 1e-4 · max(1, λ₁)."""
    X = np.random.default_rng(4).normal(size=(150, 5)).astype(np.float32)
    jm = JaxKernelPCA(affinity=JaxSelfTuning(normalization_dim=None), n_components=2,
                      solver="lobpcg", random_state=0)
    jm.fit_transform(X)
    tm = KernelPCA(affinity=SelfTuningAffinity(normalization_dim=None, device="cpu"),
                   n_components=2, solver="lobpcg", random_state=0, device="cpu")
    assert tm._kernel_block_fn() is None
    Z = tm.fit_transform(X)
    assert Z.shape == (150, 2) and np.isfinite(Z).all()
    K = np.asarray(JaxSelfTuning(normalization_dim=None)(jnp.asarray(X)))
    lam, _ = tm._lobpcg_dense(torch.from_numpy(K), X0=torch.from_numpy(_jax_start(0, 150, 2)))
    wlam = np.asarray(jm.eigenvalues_)
    np.testing.assert_allclose(lam.numpy(), wlam, atol=1e-5 * abs(wlam[0]), rtol=0)
    eigh = KernelPCA(affinity=SelfTuningAffinity(normalization_dim=None, device="cpu"),
                     n_components=2, device="cpu")
    eigh.fit_transform(X)
    lam_eigh = eigh.eigenvalues_[:2].numpy()
    assert np.abs(tm.eigenvalues_.numpy() - lam_eigh).max() < 1e-4 * max(1.0, lam_eigh[0])


def test_kernel_pca_lobpcg_matches_eigh_at_defaults():
    """``tests/test_spectral.py::test_lobpcg_matches_eigh`` on the port."""
    X = np.random.default_rng(1).normal(size=(120, 8)).astype(np.float32)
    Z1 = np.abs(KernelPCA(n_components=2, solver="eigh", device="cpu").fit_transform(X))
    Z2 = np.abs(KernelPCA(n_components=2, solver="lobpcg", random_state=0,
                          device="cpu").fit_transform(X))
    assert np.abs(Z1 - Z2).max() < 1e-2


def test_kernel_pca_tol_tightens_the_stop():
    """``tol`` replaces the JAX package's stop, |r| < 10 n ε (|AX| + θ), by
    |r| < tol (|AX| + θ): at 1e-6 the near-degenerate top pairs of 2,000
    clustered rows come to 1e-5 of eigh's eigenvalues, closer than the
    default's (None, the JAX package's rule)."""
    X = _blobs(2000, 6, 11, n_clusters=8)
    def aff():
        return NormalizedGaussianAffinity(sigma=60.0, normalization_dim=None, device="cpu")
    lam = KernelPCA(affinity=aff(), device="cpu")
    lam.fit_transform(X)
    lam = lam.eigenvalues_[:2].numpy()
    gaps = {}
    for tol in (None, 1e-6):
        m = KernelPCA(affinity=aff(), solver="lobpcg", random_state=0, tol=tol, device="cpu")
        m.fit_transform(X)
        gaps[tol] = (np.abs(m.eigenvalues_.numpy() - lam).max() / lam[0], m.lobpcg_iterations_)
    assert gaps[1e-6][0] < 1e-5
    assert gaps[1e-6][0] <= gaps[None][0] and gaps[1e-6][1] > gaps[None][1]


def test_kernel_pca_params_follow_the_jax_defaults():
    jm, tm = JaxKernelPCA(), KernelPCA(device="cpu")
    for name in ("n_components", "nodiag", "solver", "mesh"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert type(tm.affinity).__name__ == type(jm.affinity).__name__
    assert tm.affinity.normalization_dim is jm.affinity.normalization_dim is None
    assert tm.tol is None


# --- IncrementalPCA ---


@pytest.fixture(scope="module")
def Xa():
    """``tests/test_incremental_pca.py``'s anisotropic rows."""
    rng = np.random.default_rng(42)
    scales = np.array([10, 5, 3, 2, 1, 1, 0.5, 0.5, 0.2, 0.1], np.float32)
    return (rng.normal(size=(400, 10)) * scales).astype(np.float32)


def _ipca_close(tm, jm, Z=None, wZ=None):
    np.testing.assert_array_equal(tm.mean_, jm.mean_)
    np.testing.assert_array_equal(tm.var_, jm.var_)
    assert tm.n_samples_seen_ == jm.n_samples_seen_
    _up_to_sign(tm.components_.numpy().T, np.asarray(jm.components_).T, 1e-5)
    np.testing.assert_allclose(tm.singular_values_.numpy(), jm.singular_values_, rtol=1e-5)
    np.testing.assert_allclose(tm.explained_variance_.numpy(), jm.explained_variance_, rtol=1e-5)
    np.testing.assert_allclose(tm.explained_variance_ratio_.numpy(),
                               jm.explained_variance_ratio_, rtol=1e-5)
    np.testing.assert_allclose(tm.noise_variance_, jm.noise_variance_, rtol=1e-4, atol=1e-7)
    if Z is not None:
        _up_to_sign(np.asarray(Z), np.asarray(wZ), 1e-5 * np.abs(wZ).max())


@pytest.mark.parametrize("batch_size", [30, 64, 100, 400, None])
@pytest.mark.parametrize("k", [2, 4])
def test_incremental_pca_matches_jax(Xa, batch_size, k):
    """Across batch sizes (``tests/test_incremental_pca.py``'s 30 to 400,
    and the default): equal host statistics, components and singular values
    at 1e-5, projections at 1e-5 of their largest entry."""
    jm, tm = JaxIPCA(n_components=k, batch_size=batch_size), IncrementalPCA(
        n_components=k, batch_size=batch_size, device="cpu")
    wZ = jm.fit_transform(Xa)
    Z = tm.fit_transform(Xa)
    assert isinstance(Z, np.ndarray) and Z.shape == (400, k)
    _ipca_close(tm, jm, Z, wZ)


def test_incremental_pca_merges_a_thin_last_batch(Xa):
    """403 rows by 100 with k = 4: the last 3 rows join the fourth batch."""
    X = np.concatenate([Xa, Xa[:3] + 0.5])
    jm, tm = JaxIPCA(n_components=4, batch_size=100), IncrementalPCA(
        n_components=4, batch_size=100, device="cpu")
    wZ = jm.fit_transform(X)
    Z = tm.fit_transform(X)
    assert Z.shape == (403, 4)
    _ipca_close(tm, jm, Z, wZ)


def test_incremental_pca_partial_fit_continues_a_jax_state(Xa):
    """The JAX package fits 300 rows; its state is carried into the port,
    and both take the last 100 rows by ``partial_fit``."""
    jm = JaxIPCA(n_components=3, batch_size=100)
    jm.fit(Xa[:300])
    tm = IncrementalPCA(n_components=3, device="cpu")
    load_incremental_pca_state(tm, {
        "mean_": jm.mean_, "var_": jm.var_, "components_": jm.components_,
        "singular_values_": jm.singular_values_, "explained_variance_": jm.explained_variance_,
        "n_samples_seen_": jm.n_samples_seen_,
    })
    assert tm.mean_.dtype == np.float64 and tm.components_.dtype == torch.float32
    jm.partial_fit(Xa[300:])
    tm.partial_fit(Xa[300:])
    _ipca_close(tm, jm)


@pytest.mark.parametrize("form", ["numpy", "torch", "float64", "int32"])
def test_incremental_pca_transform_new_rows_matches_jax(Xa, form):
    """``transform`` of rows the fit did not see, projected on the device
    in float32 (the JAX package projects on the host in float64): 1e-5 of
    the largest entry; a tensor comes back as a tensor."""
    jm, tm = JaxIPCA(n_components=3, batch_size=100), IncrementalPCA(
        n_components=3, batch_size=100, device="cpu")
    jm.fit(Xa[:300])
    tm.fit(Xa[:300])
    new = {"numpy": Xa[300:], "torch": torch.from_numpy(Xa[300:]),
           "float64": Xa[300:].astype(np.float64), "int32": (Xa[300:] * 10).astype(np.int32)}[form]
    want = np.asarray(jm.transform(np.asarray(new)))
    got = tm.transform(new)
    assert isinstance(got, torch.Tensor) == (form == "torch")
    got = np.asarray(got)
    _up_to_sign(got, want, 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("form", ["list", "generator", "pairs", "tensor"])
def test_incremental_pca_takes_batches(Xa, form):
    """Arrays, tensors and iterables of batches or ``(x, y)`` pairs give the
    fit of the same batches as an array."""
    batches = [Xa[i : i + 80] for i in range(0, 400, 80)]
    data = {"list": batches, "generator": (b for b in batches),
            "pairs": [(torch.from_numpy(b), None) for b in batches],
            "tensor": torch.from_numpy(Xa)}[form]
    ref = IncrementalPCA(n_components=3, batch_size=80, device="cpu")
    want = ref.fit_transform(Xa)
    tm = IncrementalPCA(n_components=3, batch_size=80, device="cpu")
    got = tm.fit_transform(data)
    assert isinstance(got, torch.Tensor) == (form == "tensor")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_incremental_pca_errors():
    """``tests/test_incremental_pca.py``'s validation errors on the port."""
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="n_components"):
        IncrementalPCA(n_components=8, device="cpu").fit(np.zeros((50, 4), np.float32))
    with pytest.raises(ValueError, match="fewer"):
        IncrementalPCA(n_components=6, device="cpu").partial_fit(
            rng.normal(size=(3, 8)).astype(np.float32))
    m = IncrementalPCA(n_components=2, device="cpu")
    m.partial_fit(rng.normal(size=(50, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="features"):
        m.partial_fit(rng.normal(size=(50, 5)).astype(np.float32))
    with pytest.raises(ValueError):
        IncrementalPCA(n_components=2, device="cpu").transform(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="2D"):
        IncrementalPCA(n_components=2, device="cpu").partial_fit(np.zeros(7, np.float32))


# --- ExactIncrementalPCA ---


@pytest.mark.parametrize("batch_size", [30, 100, 400])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_exact_incremental_pca_matches_jax(Xa, batch_size, dtype):
    """Σx and XᵀX by batch, one float64 eigh: components and explained
    variance at 1e-5, projections at 1e-5 of their largest entry, for
    float32 and float64 input."""
    X = Xa.astype(dtype)
    jm = JaxExactIPCA(n_components=4, batch_size=batch_size)
    wZ = jm.fit_transform(X)
    tm = ExactIncrementalPCA(n_components=4, batch_size=batch_size, device="cpu")
    Z = tm.fit_transform(X)
    assert Z.dtype == np.float32 and Z.shape == (400, 4) and tm.n_samples_seen_ == 400
    np.testing.assert_allclose(tm.mean_.numpy(), jm.mean_, atol=1e-6)
    _up_to_sign(tm.components_.numpy().T, np.asarray(jm.components_).T, 1e-5)
    np.testing.assert_allclose(tm.explained_variance_.numpy(), jm.explained_variance_, rtol=1e-5)
    _up_to_sign(Z, np.asarray(wZ), 1e-5 * np.abs(wZ).max())
    new = X[:7] * 1.5
    _up_to_sign(np.asarray(tm.transform(new)), np.asarray(jm.transform(new)),
                1e-5 * np.abs(wZ).max())


def test_exact_incremental_pca_reads_a_one_shot_iterator_once(Xa):
    """Both passes see every batch of a generator: it is materialised once."""
    batches = [Xa[i : i + 100] for i in range(0, 400, 100)]
    want = ExactIncrementalPCA(n_components=3, batch_size=100, device="cpu").fit_transform(Xa)
    got = ExactIncrementalPCA(n_components=3, device="cpu").fit_transform(b for b in batches)
    assert got.shape == (400, 3)
    np.testing.assert_array_equal(got, want)


def test_exact_incremental_pca_state_carried_from_jax(Xa):
    jm = JaxExactIPCA(n_components=3, batch_size=100)
    jm.fit(Xa)
    tm = ExactIncrementalPCA(n_components=3, device="cpu")
    load_incremental_pca_state(tm, {
        "mean_": jm.mean_, "components_": jm.components_,
        "explained_variance_": jm.explained_variance_, "n_samples_seen_": jm.n_samples_seen_,
    })
    want = np.asarray(jm.transform(Xa[:50]))
    np.testing.assert_allclose(np.asarray(tm.transform(Xa[:50])), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)


# --- the device mesh (ROADMAP item 20), and the device rule ---


@pytest.fixture(scope="module")
def meshes():
    from torchdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from torchdr_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cpu"] * 8), jax_make_mesh(8)


@pytest.mark.parametrize("case", ["gaussian_all_300", "student_euclidean"])
def test_kernel_pca_mesh_matches_jax(case, meshes):
    """The matrix-free operator row-sharded over an 8-device mesh in both
    packages, from the JAX package's start: the same iteration count,
    eigenvalues at 1e-5 of λ₁ and eigenvectors up to sign at 1e-4, as
    without a mesh; and the port's result equals its single-device one."""
    mesh, jax_mesh = meshes
    make_X, akw, k, T, J = MATFREE_CASES[case]
    X = make_X()
    jm = JaxKernelPCA(affinity=J(**akw), n_components=k, solver="lobpcg", random_state=0,
                      mesh=jax_mesh)
    jm.fit_transform(X)
    tm = KernelPCA(affinity=T(device="cpu", **akw), n_components=k, solver="lobpcg",
                   random_state=0, mesh=mesh, device="cpu")
    X0 = torch.from_numpy(_jax_start(0, X.shape[0], k))
    lam, U = tm._lobpcg_matfree(torch.from_numpy(X), tm._kernel_block_fn(), X0=X0)
    wlam = np.asarray(jm.eigenvalues_)
    np.testing.assert_allclose(lam.numpy(), wlam, atol=1e-5 * wlam[0], rtol=0)
    _up_to_sign(U.numpy(), np.asarray(jm.eigenvectors_), 1e-4)
    single = KernelPCA(affinity=T(device="cpu", **akw), n_components=k, solver="lobpcg",
                       random_state=0, device="cpu")
    lam1, U1 = single._lobpcg_matfree(torch.from_numpy(X), single._kernel_block_fn(), X0=X0)
    assert tm.lobpcg_iterations_ == single.lobpcg_iterations_
    np.testing.assert_allclose(lam.numpy(), lam1.numpy(), atol=1e-6 * wlam[0], rtol=0)


@pytest.mark.parametrize("inject", [False, True])
def test_exact_incremental_pca_mesh_matches_jax(Xa, inject, meshes):
    """Each batch's Σx and XᵀX row-sharded over the mesh, given at
    construction or injected by ``_set_fit_mesh``, in both packages: the
    tolerances of the single-device test."""
    mesh, jax_mesh = meshes
    if inject:
        jm, tm = JaxExactIPCA(n_components=4, batch_size=100), ExactIncrementalPCA(
            n_components=4, batch_size=100, device="cpu")
        jm._set_fit_mesh(jax_mesh)
        tm._set_fit_mesh(mesh)
    else:
        jm = JaxExactIPCA(n_components=4, batch_size=100, mesh=jax_mesh)
        tm = ExactIncrementalPCA(n_components=4, batch_size=100, mesh=mesh, device="cpu")
    wZ = jm.fit_transform(Xa)
    Z = tm.fit_transform(Xa)
    np.testing.assert_allclose(tm.mean_.numpy(), jm.mean_, atol=1e-6)
    _up_to_sign(tm.components_.numpy().T, np.asarray(jm.components_).T, 1e-5)
    np.testing.assert_allclose(tm.explained_variance_.numpy(), jm.explained_variance_, rtol=1e-5)
    _up_to_sign(Z, np.asarray(wZ), 1e-5 * np.abs(wZ).max())


def test_pca_of_row_sharded_input_matches_jax(meshes):
    """``shard_rows`` pieces take the covariance method, as a sharded array
    does in the JAX package: the embedding within 1e-2 in absolute value of
    the dense fit (``tests/test_parallel.py``'s bound) and within 1e-5 of
    its largest entry of the JAX package's sharded fit (the covariance
    method's tolerance in ``tests/test_torch_umap.py::test_pca_init_matches_jax``)."""
    from torchdr_tpu.models.spectral import PCA as JaxPCA
    from torchdr_tpu.parallel.mesh import shard_rows as jax_shard_rows
    from torchdr_tpu_torch import PCA
    from torchdr_tpu_torch.parallel import shard_rows

    mesh, jax_mesh = meshes
    X = np.random.default_rng(0).normal(size=(256, 12)).astype(np.float32)
    dense = np.abs(PCA(n_components=3, device="cpu").fit_transform(X))
    Z = PCA(n_components=3, device="cpu")._fit_transform(shard_rows(X, mesh)).numpy()
    assert np.abs(np.abs(Z) - dense).max() < 1e-2
    wZ = np.asarray(JaxPCA(n_components=3)._fit_transform(jax_shard_rows(jnp.asarray(X),
                                                                        jax_mesh)))
    np.testing.assert_allclose(Z, wZ, atol=1e-5 * np.abs(wZ).max(), rtol=0)


@pytest.mark.parametrize("make", [
    lambda: KernelPCA(mesh=object(), device="cpu"),
    lambda: ExactIncrementalPCA(mesh=object(), device="cpu"),
    lambda: ExactIncrementalPCA(device="cpu")._set_fit_mesh(object()),
])
def test_mesh_that_is_not_a_mesh_raises(make):
    with pytest.raises(TypeError, match="Mesh"):
        make()


@pytest.mark.parametrize("make", [
    lambda: KernelPCA(), lambda: KernelPCA(solver="lobpcg"), lambda: IncrementalPCA(),
    lambda: ExactIncrementalPCA(),
])
def test_device_auto_without_cuda_raises(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        make().fit_transform(_blobs(60, 4, 0))
