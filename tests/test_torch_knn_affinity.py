"""The self-tuning, MAGIC and PHATE affinities of the PyTorch port, and its
``center_kernel``, ``matrix_power`` and ``check_nonnegativity_eigenvalues``,
against the JAX package.

The same seeded numpy inputs go through both packages, at the JAX package's
own test sizes (``tests/test_affinity.py``: 120 × 10 rows;
``tests/test_affinity_depth.py``: three clusters of 40 rows in 8-D). The
JAX affinities cast their input to float32, so each is also held to a
float64 numpy evaluation; the reductions are evaluated by JAX in float32 and
in float64 (``jax.enable_x64``). Tolerances, each stated at its test:

- SelfTuning: logs 3e-5 of max(|log|, 1), probabilities 5e-6; MAGIC 5e-6;
- ``center_kernel`` 1e-6, ``matrix_power`` 3e-6 of the largest entry;
- PHATE's negative potential distances 1e-3 of the largest distance (the
  float32 rounding of a zero distance in the norms-plus-gram form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu.affinity import MAGICAffinity as JaxMAGIC
from torchdr_tpu.affinity import PHATEAffinity as JaxPHATE
from torchdr_tpu.affinity import SelfTuningAffinity as JaxSelfTuning
from torchdr_tpu.ops import reductions as jred
from torchdr_tpu_torch import MAGICAffinity, PHATEAffinity, SelfTuningAffinity
from torchdr_tpu_torch.ops import reductions as tred


def _depth_X():
    """``tests/test_affinity_depth.py``'s rows."""
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=5.0, size=(3, 8))
    return np.concatenate([c + rng.normal(size=(40, 8)) for c in centers]).astype(np.float32)


def _affinity_X():
    """``tests/test_affinity.py``'s rows."""
    return np.random.default_rng(0).normal(size=(120, 10)).astype(np.float32)


DATA = {"depth": _depth_X, "affinity": _affinity_X}


def _jax(make, X, **call):
    aff = make()
    return np.asarray(aff(jnp.asarray(X), **call)), aff


def _sq_dists64(X, zero_diag):
    X = np.asarray(X, np.float64)
    X = X - X.mean(0)
    C = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return C + 1e12 * np.eye(len(X)) if zero_diag else C


def _self_tuning64(X, K, norm):
    """SelfTuningAffinity's log affinity in float64 numpy."""
    from scipy.special import logsumexp

    C = _sq_dists64(X, True)
    kth = np.sort(C, axis=1)[:, K - 1]
    L = -C / (kth[:, None] * kth[None, :])
    return L if norm is None else L - logsumexp(L, axis=norm, keepdims=True)


def _magic64(X, K):
    C = _sq_dists64(X, True)
    kth = np.sort(C, axis=1)[:, K - 1]
    P = np.exp(-C / kth[:, None])
    P = 0.5 * (P + P.T)
    return P / P.sum(1, keepdims=True)


def _log_close(got, want, rtol):
    """|got − want| ≤ rtol · max(|want|, 1) on the entries that are not the
    masked diagonal (~1e12 / σ²)."""
    keep = np.abs(want) < 1e6
    err = np.abs(got - want)[keep] / np.maximum(np.abs(want[keep]), 1.0)
    assert err.max() <= rtol, err.max()


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("norm", [None, 1, (0, 1)], ids=["none", "rows", "all"])
def test_self_tuning_matches_jax(data, norm):
    """Log affinities at 3e-5 of max(|log|, 1), probabilities at 5e-6
    absolute, against the JAX package and float64 numpy, and the bandwidths
    σ_i (the K-th smallest distance of each row) at 1e-5 relative. On the
    depth rows both packages are ~1e-5 relative from float64 (measured 1.5e-5
    port, 9.6e-6 JAX): the norms-plus-gram distances cancel for clusters 5
    apart, and the logs reach 27."""
    X = DATA[data]()
    want_log, jaff = _jax(lambda: JaxSelfTuning(K=7, normalization_dim=norm), X, log=True)
    ref_log = _self_tuning64(X, 7, norm)
    aff = SelfTuningAffinity(K=7, normalization_dim=norm, device="cpu")
    got = aff(X).numpy()
    got_log = aff(X, log=True).numpy()
    for want in (want_log, ref_log):
        _log_close(got_log, want, 3e-5)
        np.testing.assert_allclose(got, np.exp(want), atol=5e-6, rtol=0)
    np.testing.assert_allclose(aff.sigma_.numpy(), np.asarray(jaff.sigma_), rtol=1e-5)
    if norm == 1:
        assert np.abs(got.sum(1) - 1.0).max() < 1e-4  # the JAX package's own check


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("K", [3, 7])
def test_magic_matches_jax(data, K):
    """The row-stochastic diffusion operator at 5e-6 absolute against the
    JAX package and float64 numpy (measured 1.2e-6 from the JAX package),
    and σ_i at 5e-5 relative: the float32 rounding of a squared distance,
    ~ε|x|², is 1.2e-5 of the smallest third-neighbour distance of the depth
    rows."""
    X = DATA[data]()
    want, jaff = _jax(lambda: JaxMAGIC(K=K), X)
    aff = MAGICAffinity(K=K, device="cpu")
    got = aff(X).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    np.testing.assert_allclose(got, _magic64(X, K), atol=5e-6, rtol=0)
    np.testing.assert_allclose(aff.sigma_.numpy(), np.asarray(jaff.sigma_), rtol=5e-5)
    assert np.abs(got.sum(1) - 1.0).max() < 1e-4 and (got >= 0).all()


def _phate_float64(X, k, alpha, t):
    """PHATEAffinity in float64 numpy, distances by direct differences."""
    C = np.sqrt(_sq_dists64(X, False))
    kth = np.sort(C, axis=1)[:, k - 1]
    P = np.exp(-((C / kth[:, None]) ** alpha))
    P = 0.5 * (P + P.T)
    P = P / P.sum(1, keepdims=True)
    P = np.linalg.matrix_power(P, t)
    logP = -np.log(np.clip(P, 1e-12, None))
    logP = logP - logP.mean(0, keepdims=True)
    return -np.sqrt(((logP[:, None, :] - logP[None, :, :]) ** 2).sum(-1))


PHATE_CASES = [("affinity", 5, 3, 60), ("depth", 6, 2, None), ("depth", 6, 16, None),
               ("depth", 5, 100, None)]


@pytest.mark.parametrize("data, k, t, rows", PHATE_CASES)
def test_phate_matches_jax(data, k, t, rows):
    """The negative potential distances at the JAX package's sizes
    (``PHATEAffinity(k=5, t=3)`` on 60 rows; t = 2, 16 and the estimator's
    100) against the JAX package and float64 numpy, at 1e-3 of the largest
    distance: both packages form them as sqrt(|a|² + |b|² − 2a·b) in
    float32, which at a zero distance reads up to sqrt(2 · 2⁻²³) |a| =
    4.9e-4 |a| (measured: 2.1e-4 to 5.8e-4 of the largest distance between
    the packages, and the JAX package as far from float64). Also the JAX
    package's own checks (finite, ≤ 1e-6, symmetric to 1e-3)."""
    X = DATA[data]()[:rows]
    want, _ = _jax(lambda: JaxPHATE(k=k, t=t), X)
    aff = PHATEAffinity(k=k, t=t, device="cpu")
    got = aff(X).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=0)
    np.testing.assert_allclose(got, _phate_float64(X, k, 10.0, t), atol=1e-3 * scale, rtol=0)
    assert np.isfinite(got).all() and (got <= 1e-6).all()
    assert np.abs(got - got.T).max() < 1e-3


def test_phate_t_changes_the_operator():
    """``tests/test_affinity_depth.py``: t = 2 and 16 differ, t = 150 stays
    finite in float32."""
    X = _depth_X()
    P1 = PHATEAffinity(k=6, t=2, device="cpu")(X).numpy()
    P2 = PHATEAffinity(k=6, t=16, device="cpu")(X).numpy()
    assert np.abs(P1 - P2).max() > 1e-6
    assert np.isfinite(PHATEAffinity(k=6, t=150, device="cpu")(X).numpy()).all()


def _row_stochastic(n=90, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)).astype(np.float32) ** 4
    A = 0.5 * (A + A.T)
    return (A / A.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("p", [0, 1, 2, 3, 5, 16, 100, 100.0, 0.5, 1.5])
def test_matrix_power_matches_jax(p):
    """Integer powers by repeated squaring in ``jnp.linalg.matrix_power``'s
    order, fractional powers through ``eigh`` of the symmetric part, as
    ``jnp.linalg.eigh`` symmetrizes: in float32 at 3e-6 of the largest
    entry against the JAX package in float32 and in float64 (measured up to
    1.8e-6 and 1.3e-6, at p = 1.5; the JAX package's own float32 is 1.2e-6
    from its float64), and in float64 at 1e-12 against the JAX package in
    float64."""
    A = _row_stochastic()
    want32 = np.asarray(jred.matrix_power(jnp.asarray(A), p))
    with jax.enable_x64(True):
        want64 = np.asarray(jred.matrix_power(jnp.asarray(A, jnp.float64), p))
    got32 = tred.matrix_power(torch.from_numpy(A), p).numpy()
    got64 = tred.matrix_power(torch.from_numpy(A).double(), p).numpy()
    scale = np.abs(want64).max()
    assert got32.dtype == np.float32 and got64.dtype == np.float64
    np.testing.assert_allclose(got32, want32, atol=3e-6 * scale, rtol=0)
    np.testing.assert_allclose(got32, want64, atol=3e-6 * scale, rtol=0)
    np.testing.assert_allclose(got64, want64, atol=1e-12 * scale, rtol=0)


def test_matrix_power_inverts_negative_powers():
    A = np.eye(4, dtype=np.float64) * 2 + 0.1
    got = tred.matrix_power(torch.from_numpy(A), -2).numpy()
    np.testing.assert_allclose(got, np.asarray(jred.matrix_power(jnp.asarray(A, jnp.float32), -2)),
                               rtol=1e-5)


@pytest.mark.parametrize("n, seed", [(7, 0), (120, 1)])
def test_center_kernel_matches_jax(n, seed):
    """Double centring at 1e-6; rows and columns of the result sum to 0."""
    K = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    want = np.asarray(jred.center_kernel(jnp.asarray(K)))
    got = tred.center_kernel(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.abs(got.sum(0)).max() < 1e-4 and np.abs(got.sum(1)).max() < 1e-4


def test_check_nonnegativity_eigenvalues_matches_jax():
    """Negative values above -tol become 0; the others stay."""
    ev = np.array([3.0, 1e-3, 0.0, -5e-7, -1e-6, -2e-6, -0.5], np.float32)
    want = np.asarray(jred.check_nonnegativity_eigenvalues(jnp.asarray(ev)))
    got = tred.check_nonnegativity_eigenvalues(torch.from_numpy(ev)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("make", [SelfTuningAffinity, MAGICAffinity, PHATEAffinity])
def test_device_auto_without_cuda_raises(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()(_depth_X())


@pytest.mark.parametrize("make, jmake", [
    (SelfTuningAffinity, JaxSelfTuning), (MAGICAffinity, JaxMAGIC), (PHATEAffinity, JaxPHATE),
])
def test_params_follow_the_jax_defaults(make, jmake):
    port, ref = make(device="cpu"), jmake()
    for name in ("K", "k", "t", "alpha", "normalization_dim", "metric", "zero_diag"):
        if hasattr(ref, name):
            assert getattr(port, name) == getattr(ref, name), name
