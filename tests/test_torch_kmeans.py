"""k-means of the PyTorch port (torchdr_tpu_torch/ops/kmeans.py) against the
JAX package, and the behaviours of ``tests/test_kmeans.py`` on the port.

The random draws of the two packages differ, so the parity cases feed the
port the JAX package's own seeding (``_plus_plus_init`` for "++", the row
stride from ``jax.random.randint`` for "random") through ``init_centers``.
From the same seeding both run the same Lloyd iterations in float32, so the
labels agree exactly, the centres to 1e-5 and the inertia to 1e-5 relative
(sums in another order). The JAX function is evaluated in float64 as well,
where a float32 reference could drift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu.ops.kmeans import _plus_plus_init as jax_plus_plus_init
from torchdr_tpu.ops.kmeans import kmeans_fit as jax_kmeans_fit
from torchdr_tpu_torch.ops.kmeans import kmeans_fit


def blobs(n=600, k=6, d=8, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(k, d)).astype(np.float32)
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d)).astype(np.float32)), lab, centers


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def jax_seeding(X, n_clusters, key, init):
    """The JAX package's initial centres for ``kmeans_fit(X, n_clusters, key,
    init=init)``, as numpy."""
    Xj = jnp.asarray(X)
    if init == "random":
        n = X.shape[0]
        stride = max(1, n // n_clusters)
        start = int(jax.random.randint(key, (), 0, jnp.asarray(stride)))
        return X[start + stride * np.arange(n_clusters)].copy()
    return np.array(jax_plus_plus_init(Xj, jnp.sum(Xj * Xj, -1), n_clusters, key))


@pytest.mark.parametrize("init, n_clusters, max_iter, seed", [
    ("++", 6, 50, 0), ("++", 24, 30, 1), ("random", 64, 40, 2), ("random", 8, 0, 3),
    ("++", 5, 3, 4),
])
def test_kmeans_matches_jax_from_its_seeding(init, n_clusters, max_iter, seed):
    X, _, _ = blobs(n=2000 if init == "random" else 600, seed=seed)
    key = jax.random.PRNGKey(seed)
    c0 = jax_seeding(X, n_clusters, key, init)
    wc, wl, wi = jax_kmeans_fit(jnp.asarray(X), n_clusters, key, max_iter=max_iter, init=init)
    gc, gl, gi = kmeans_fit(torch.from_numpy(X), n_clusters, max_iter=max_iter,
                            init_centers=torch.from_numpy(c0))
    assert gl.dtype == torch.int32 and np.asarray(wl).dtype == np.int32
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5)
    np.testing.assert_allclose(float(gi), float(wi), rtol=1e-5)


def test_kmeans_matches_jax_in_float64():
    """The same comparison with the JAX function in float64: the port's
    float32 centres within 1e-5, inertia within 1e-5 relative. The seeding
    is drawn as the JAX function draws it in float64 mode, and the blobs are
    well apart, so no row lies near a boundary that float32 could move it
    across."""
    X, _, _ = blobs(n=1000, seed=5)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        c0 = jax_seeding(X.astype(np.float64), 6, key, "++").astype(np.float32)
        wc, wl, wi = jax_kmeans_fit(jnp.asarray(X, jnp.float64), 6, key, max_iter=50)
        wc, wl, wi = np.asarray(wc), np.asarray(wl), float(wi)
    assert wc.dtype == np.float64
    gc, gl, gi = kmeans_fit(torch.from_numpy(X), 6, max_iter=50, init_centers=torch.from_numpy(c0))
    np.testing.assert_array_equal(gl.numpy(), wl)
    np.testing.assert_allclose(gc.numpy(), wc, atol=1e-5)
    np.testing.assert_allclose(float(gi), wi, rtol=1e-5)


@pytest.mark.parametrize("init", ["++", "random"])
def test_stop_test_every_few_iterations_is_bit_identical(init):
    """Reading the stop flag every 8 iterations gives the state of reading
    it every iteration: the loop freezes once the inertia stops moving."""
    X, _, _ = blobs(n=800, seed=6)
    a = kmeans_fit(torch.from_numpy(X), 12, _gen(0), max_iter=100, init=init, sync_every=1)
    b = kmeans_fit(torch.from_numpy(X), 12, _gen(0), max_iter=100, init=init, sync_every=8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_n_below_n_clusters_raises_as_jax():
    X = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="n >= n_clusters"):
        jax_kmeans_fit(jnp.asarray(X), 5, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="n >= n_clusters"):
        kmeans_fit(torch.from_numpy(X), 5)


# the eight behaviours of tests/test_kmeans.py, on the port


def test_recovers_separated_centers():
    X, _, centers = blobs()
    cen, _, _ = kmeans_fit(torch.from_numpy(X), 6, _gen(0), max_iter=50)
    d = np.linalg.norm(cen.numpy()[None, :, :] - centers[:, None, :], axis=-1).min(axis=1)
    assert d.max() < 1.5


def test_labels_match_partition():
    from sklearn.metrics import adjusted_rand_score

    X, lab, _ = blobs()
    _, labels, _ = kmeans_fit(torch.from_numpy(X), 6, _gen(0), max_iter=50)
    assert adjusted_rand_score(lab, labels.numpy()) > 0.99


def test_inertia_decreases_with_k():
    X, _, _ = blobs()
    inertias = [float(kmeans_fit(torch.from_numpy(X), k, _gen(0), max_iter=50)[2])
                for k in (2, 4, 8)]
    assert inertias[0] > inertias[1] > inertias[2]


def test_deterministic_given_generator():
    X, _, _ = blobs()
    c1, l1, _ = kmeans_fit(torch.from_numpy(X), 5, _gen(3), max_iter=30)
    c2, l2, _ = kmeans_fit(torch.from_numpy(X), 5, _gen(3), max_iter=30)
    assert torch.equal(l1, l2) and torch.allclose(c1, c2)


def test_k_equals_n():
    X = torch.randn((16, 4), generator=_gen(0))
    _, _, inertia = kmeans_fit(X, 16, _gen(0), max_iter=10)
    assert float(inertia) < 1e-3  # every point its own center


def test_more_clusters_than_modes_no_nan():
    X, _, _ = blobs(k=3)
    cen, _, _ = kmeans_fit(torch.from_numpy(X), 24, _gen(1), max_iter=30)
    assert bool(torch.isfinite(cen).all())


def test_random_init_usable_in_coarse_regime():
    """init="random" lands near ++'s inertia when n_clusters is well above
    the number of modes, and its cells each hold a single blob."""
    from sklearn.metrics import homogeneity_score

    X, lab, _ = blobs(n=2000, k=6)
    _, labels, inertia = kmeans_fit(torch.from_numpy(X), 64, _gen(0), max_iter=40, init="random")
    _, _, inertia_pp = kmeans_fit(torch.from_numpy(X), 64, _gen(0), max_iter=40, init="++")
    assert float(inertia) < 1.5 * float(inertia_pp)
    assert homogeneity_score(lab, labels.numpy()) > 0.95


def test_random_init_centers_are_rows():
    X, _, _ = blobs(n=64)
    cen, _, _ = kmeans_fit(torch.from_numpy(X), 8, _gen(2), max_iter=0, init="random")
    for c in cen.numpy():
        assert np.min(np.linalg.norm(X - c, axis=1)) < 1e-6
