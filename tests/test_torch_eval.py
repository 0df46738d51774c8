"""The PyTorch port's ``eval`` functions against the JAX package's.

The same seeded numpy inputs go through both packages. Tolerances:

- kNN label accuracy, neighbourhood preservation (full and sampled: the
  same seeded numpy draw of query rows) and kNN recall: equal up to the
  float32 rounding of a mean (1e-7), on data without distance ties;
- silhouette samples at 1e-6 (5e-5 for "euclidean", whose self-distance
  rounds), each against float64 as well, the score against sklearn at 1e-3
  (the JAX package's own test);
- the adjusted Rand index equal (the same numpy arithmetic); ``kmeans_ari``
  from the JAX package's own seeding (``init_centers``): the same labels
  and index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu import eval as jeval
from torchdr_tpu.ops.kmeans import _plus_plus_init as jax_plus_plus_init
from torchdr_tpu_torch import eval as teval


def _embedding(X, k=2, seed=0):
    """A fixed linear map of X: an embedding with neighbourhood loss."""
    W = np.random.default_rng(seed).normal(size=(X.shape[1], k)).astype(np.float32)
    return (X @ W).astype(np.float32)


@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("labels", ["true", "random"])
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_knn_label_accuracy_matches_jax(toy_blobs, k, labels, metric):
    """``tests/test_eval.py``'s cases (above 0.9 on separated blobs, below
    0.5 on random labels), per sample and in the mean."""
    X, y = toy_blobs
    if labels == "random":
        y = np.random.default_rng(0).integers(0, 4, X.shape[0])
    Z = _embedding(X)
    for data in (X, Z):
        want = jeval.knn_label_accuracy(data, y, k=k, metric=metric)
        got = teval.knn_label_accuracy(data, y, k=k, metric=metric, device="cpu")
        assert got == pytest.approx(want, abs=1e-7)
        per = teval.knn_label_accuracy(data, y, k=k, metric=metric, return_per_sample=True,
                                       device="cpu")
        np.testing.assert_allclose(per.numpy(), np.asarray(jeval.knn_label_accuracy(
            data, y, k=k, metric=metric, return_per_sample=True)), atol=1e-7, rtol=0)
    acc = teval.knn_label_accuracy(X, y, k=k, device="cpu")
    assert acc > 0.9 if labels == "true" else acc < 0.5


@pytest.mark.parametrize("K", [5, 10, 30])
def test_neighborhood_preservation_matches_jax(toy_blobs, K):
    X, _ = toy_blobs
    Z = _embedding(X)
    want = jeval.neighborhood_preservation(X, Z, K=K)
    assert teval.neighborhood_preservation(X, Z, K=K, device="cpu") == pytest.approx(
        want, abs=1e-7)
    per = teval.neighborhood_preservation(X, Z, K=K, return_per_sample=True, device="cpu")
    np.testing.assert_array_equal(per.numpy(), np.asarray(
        jeval.neighborhood_preservation(X, Z, K=K, return_per_sample=True)))
    assert teval.neighborhood_preservation(X, X, K=K, device="cpu") == pytest.approx(1.0)


@pytest.mark.parametrize("n_queries, seed", [(64, 0), (150, 3), (200, 1), (10_000, 2)])
def test_neighborhood_preservation_sampled_matches_jax(toy_blobs, n_queries, seed):
    """The same seeded numpy draw of query rows in both packages; with every
    row drawn it equals the full metric (``tests/test_eval.py``)."""
    X, _ = toy_blobs
    Z = _embedding(X, seed=seed)
    want = jeval.neighborhood_preservation_sampled(X, Z, K=10, n_queries=n_queries, seed=seed)
    got = teval.neighborhood_preservation_sampled(X, Z, K=10, n_queries=n_queries, seed=seed,
                                                  device="cpu")
    assert got == pytest.approx(want, abs=1e-7)
    if n_queries >= X.shape[0]:
        assert got == pytest.approx(teval.neighborhood_preservation(X, Z, K=10, device="cpu"),
                                    abs=1e-6)
    assert teval.neighborhood_preservation_sampled(X, X, K=10, n_queries=64,
                                                   device="cpu") == pytest.approx(1.0)


def test_knn_recall_matches_jax():
    rng = np.random.default_rng(4)
    true = np.stack([rng.permutation(50)[:10] for _ in range(40)]).astype(np.int32)
    pred = true.copy()
    pred[::3, :4] = rng.integers(50, 60, (len(pred[::3]), 4))
    want = jeval.knn_recall(pred, true)
    assert teval.knn_recall(pred, true, device="cpu") == pytest.approx(want, abs=1e-7)
    np.testing.assert_array_equal(
        teval.knn_recall(torch.from_numpy(pred), true, return_per_sample=True,
                         device="cpu").numpy(),
        np.asarray(jeval.knn_recall(pred, true, return_per_sample=True)))


def _silhouette64(X, y, w, metric):
    """Silhouette samples in float64 by direct distances."""
    from scipy.spatial.distance import cdist

    D = cdist(X.astype(np.float64), X.astype(np.float64),
              "cityblock" if metric == "manhattan" else metric)
    w = np.ones(len(y)) if w is None else w.astype(np.float64)
    out = np.zeros(len(y))
    for i in range(len(y)):
        own = y == y[i]
        a = (D[i] * w)[own].sum() / (w[own].sum() - w[i])
        b = min((D[i] * w)[y == c].sum() / w[y == c].sum() for c in np.unique(y) if c != y[i])
        out[i] = (b - a) / max(a, b)
    return out


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "manhattan"])
@pytest.mark.parametrize("weighted", [False, True])
def test_silhouette_samples_match_jax(toy_blobs, metric, weighted):
    """Against the JAX package and float64: 1e-6, and 5e-5 for "euclidean",
    where the norms-plus-gram form reads a point's distance to itself as
    sqrt of a rounding error, ~sqrt(ε)|x|, in both packages (measured 2.4e-5
    from float64, the JAX package 2.6e-5)."""
    X, y = toy_blobs
    Z = _embedding(X)
    w = np.random.default_rng(5).uniform(0.5, 2.0, X.shape[0]).astype(np.float32) if weighted \
        else None
    tol = 5e-5 if metric == "euclidean" else 1e-6
    for data in (X, Z):
        want = np.asarray(jeval.silhouette_samples(data, y, weights=w, metric=metric))
        got = teval.silhouette_samples(data, y, weights=w, metric=metric, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        np.testing.assert_allclose(got, _silhouette64(data, y, w, metric), atol=tol, rtol=0)


def test_silhouette_in_row_blocks_matches_jax():
    """Past 4,096 rows both packages stream row blocks; a singleton cluster
    scores 0."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(4500, 3)).astype(np.float32)
    y = rng.integers(0, 5, 4500)
    y[7] = 9
    want = np.asarray(jeval.silhouette_samples(X, y))
    got = teval.silhouette_samples(X, y, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[7] == 0.0


def test_silhouette_score_matches_sklearn(toy_blobs):
    """``tests/test_eval.py``'s check, and the subsample of ``sample_size``
    rows (a torch draw: the JAX package's differs) within 0.05 of the full
    score on these blobs."""
    from sklearn.metrics import silhouette_score as sk

    X, y = toy_blobs
    ours = teval.silhouette_score(X, y, metric="euclidean", device="cpu")
    assert abs(ours - sk(X, y, metric="euclidean")) < 1e-3
    assert ours == pytest.approx(jeval.silhouette_score(X, y, metric="euclidean"), abs=1e-5)
    sub = teval.silhouette_score(X, y, metric="euclidean", sample_size=120, random_state=3,
                                 device="cpu")
    assert abs(sub - ours) < 0.05
    assert sub == teval.silhouette_score(X, y, metric="euclidean", sample_size=120,
                                         random_state=3, device="cpu")


def test_silhouette_needs_two_labels():
    with pytest.raises(ValueError, match="at least 2 labels"):
        teval.silhouette_samples(np.zeros((5, 2), np.float32), np.zeros(5), device="cpu")


def test_adjusted_rand_index_matches_jax_and_sklearn(toy_blobs):
    from sklearn.metrics import adjusted_rand_score

    _, y = toy_blobs
    rng = np.random.default_rng(0)
    noisy = y.copy()
    noisy[rng.choice(len(y), 30, replace=False)] = rng.integers(0, 4, 30)
    for pred in (y, noisy, rng.integers(0, 7, len(y)), np.zeros(len(y))):
        got = teval.adjusted_rand_index(y, pred)
        assert got == jeval.adjusted_rand_index(y, pred)
        assert got == pytest.approx(adjusted_rand_score(y, pred), abs=1e-12)


@pytest.mark.parametrize("random_state, n_init, max_iter", [(0, 3, 100), (5, 2, 3), (None, 1, 100)])
def test_kmeans_ari_from_the_jax_seeding_matches_jax(toy_blobs, random_state, n_init, max_iter):
    """The JAX package's restarts (key, sub = split(key) from PRNGKey(seed))
    seeded by its own k-means++, given to the port as ``init_centers``: the
    same predicted labels and index (Lloyd in float32 from the same centres,
    ``tests/test_torch_kmeans.py``)."""
    X, y = toy_blobs
    Z = _embedding(X, k=3)
    key = jax.random.PRNGKey(random_state or 0)
    centers = []
    Zj = jnp.asarray(Z)
    for _ in range(n_init):
        key, sub = jax.random.split(key)
        centers.append(np.array(jax_plus_plus_init(Zj, jnp.sum(Zj * Zj, -1), 4, sub)))
    want_ari, want_pred = jeval.kmeans_ari(Z, y, random_state=random_state, n_init=n_init,
                                           max_iter=max_iter)
    got_ari, got_pred = teval.kmeans_ari(Z, y, random_state=random_state, n_init=n_init,
                                         max_iter=max_iter, init_centers=centers, device="cpu")
    np.testing.assert_array_equal(got_pred, np.asarray(want_pred))
    assert got_ari == want_ari


def test_kmeans_ari_recovers_blobs(toy_blobs):
    """``tests/test_eval.py``: above 0.9 with the port's own seeding."""
    X, y = toy_blobs
    ari, pred = teval.kmeans_ari(X, y, random_state=0, device="cpu")
    assert ari > 0.9 and pred.shape == y.shape


def test_kmeans_ari_on_fewer_distinct_rows_than_clusters():
    """Every squared distance reaches 0 during k-means++ seeding: the draw
    takes row 0, as the JAX package's does, where torch's multinomial
    would raise."""
    X = np.repeat(np.eye(3, dtype=np.float32), 10, axis=0)
    y = np.repeat(np.arange(5), 6)
    ari, pred = teval.kmeans_ari(X, y, n_clusters=5, random_state=0, device="cpu")
    assert np.isfinite(ari) and pred.shape == (30,)


@pytest.mark.parametrize("per_sample", [False, True])
def test_knn_label_accuracy_over_a_mesh_matches_jax(toy_blobs, per_sample):
    """The kNN build row-sharded over an 8-device mesh in both packages
    (the JAX package's ``TestDistributedEval``): the same scores at 1e-6."""
    from torchdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from torchdr_tpu_torch.parallel import make_mesh

    X, y = toy_blobs
    want = jeval.knn_label_accuracy(X, y, k=10, mesh=jax_make_mesh(8),
                                    return_per_sample=per_sample)
    got = teval.knn_label_accuracy(X, y, k=10, mesh=make_mesh(devices=["cpu"] * 8),
                                   return_per_sample=per_sample, device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6, rtol=0)


def test_neighborhood_preservation_over_a_mesh_matches_jax(toy_blobs):
    from torchdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from torchdr_tpu_torch.parallel import make_mesh

    X, _ = toy_blobs
    Z = X[:, :2] + 0.1 * np.random.default_rng(0).normal(size=(X.shape[0], 2)).astype(np.float32)
    want = jeval.neighborhood_preservation(X, Z, K=10, mesh=jax_make_mesh(8))
    got = teval.neighborhood_preservation(X, Z, K=10, mesh=make_mesh(devices=["cpu"] * 8),
                                          device="cpu")
    assert got == pytest.approx(want, abs=1e-6)
    assert got == pytest.approx(teval.neighborhood_preservation(X, Z, K=10, device="cpu"),
                                abs=1e-6)


@pytest.mark.parametrize("call", [
    lambda X, y: teval.knn_label_accuracy(X, y, mesh=object(), device="cpu"),
    lambda X, y: teval.neighborhood_preservation(X, X, K=5, mesh=object(), device="cpu"),
])
def test_mesh_that_is_not_a_mesh_raises(toy_blobs, call):
    with pytest.raises(TypeError, match="Mesh"):
        call(*toy_blobs)


@pytest.mark.parametrize("call", [
    lambda X, y: teval.knn_label_accuracy(X, y),
    lambda X, y: teval.neighborhood_preservation(X, X, K=5),
    lambda X, y: teval.neighborhood_preservation_sampled(X, X, K=5),
    lambda X, y: teval.knn_recall(y[:, None], y[:, None]),
    lambda X, y: teval.silhouette_score(X, y),
    lambda X, y: teval.kmeans_ari(X, y),
])
def test_device_auto_without_cuda_raises(toy_blobs, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        call(*toy_blobs)
