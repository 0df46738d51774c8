"""Product quantization of the PyTorch port (torchdr_tpu_torch/ops/pq.py)
against the JAX package, and ``TestPQ``'s behaviours (tests/test_ops.py).

The codebooks are trained from the JAX package's draws (each subspace's
k-means++ seeding, the rows ``jax.random.choice`` takes), carried across as
``init_centers`` and ``train_rows``. In the data every subspace takes 256
distinct points, so each codeword sits on one of them and no row lies near
a boundary that float32 rounding could move it across (on clustered data
256 codewords split the clusters, and the two packages' Lloyd steps part
ways): the codebooks agree to 1e-5 and the codes exactly.
ADC and refined searches from the JAX codebook agree up to ties: a slot
may differ only where its distance equals another of the row's within
1e-5 relative, or sits at the k-th place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu.ops import pq as jpq
from torchdr_tpu.ops.distance import knn_graph as jax_knn_graph
from torchdr_tpu.ops.kmeans import _plus_plus_init as jax_plus_plus_init
from torchdr_tpu_torch.ops import pq as tpq
from torchdr_tpu_torch.ops.distance import knn_graph


def _grid(d=16, M=8, per_point=8, seed=0):
    """256 · ``per_point`` rows whose every subspace takes each of 256
    distinct points (scale 5) ``per_point`` times, independently per
    subspace. k-means++ then seeds one codeword on each point (a taken
    point's copies weigh 0), and Lloyd's first step keeps them there: both
    packages reach the same codebooks however they round."""
    rng = np.random.default_rng(seed)
    dsub = d // M
    cols = []
    for _ in range(M):
        points = rng.normal(scale=5.0, size=(256, dsub))
        cols.append(points[rng.permutation(np.repeat(np.arange(256), per_point))])
    return np.concatenate(cols, axis=1).astype(np.float32)


def _clustered(n=3000, d=32, seed=0):
    """TestPQ's data: 20 clusters at scale 10, unit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=10.0, size=(20, d)).astype(np.float32)
    return centers[rng.integers(0, 20, n)] + rng.normal(size=(n, d)).astype(np.float32)


def _jax_seedings(X, M, key):
    """Each subspace's k-means++ seeding, as ``jpq.pq_train(X, M, key)``
    draws it (one key per subspace from ``jax.random.split``)."""
    n, d = X.shape
    sub = jnp.asarray(X).reshape(n, M, d // M).transpose(1, 0, 2)
    keys = jax.random.split(key, M)
    return np.stack([np.array(jax_plus_plus_init(sub[m], jnp.sum(sub[m] ** 2, -1), 256, keys[m]))
                     for m in range(M)])


def assert_same_up_to_ties(got_d, got_i, want_d, want_i, rtol=1e-5):
    got_d, got_i = np.asarray(got_d, np.float64), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d, np.float64), np.asarray(want_i)
    assert got_i.dtype == np.int32 and got_i.shape == want_i.shape
    scale = np.maximum(1.0, np.abs(want_d))
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-4 * scale.max())
    k = want_i.shape[1]
    for r, j in zip(*np.nonzero(got_i != want_i)):
        tie = np.abs(want_d[r] - want_d[r, j]) <= rtol * scale[r]
        assert j == k - 1 or tie.sum() > 1, (r, j, got_i[r], want_i[r])


@pytest.fixture(scope="module")
def trained():
    X = _grid()
    key = jax.random.PRNGKey(0)
    cb_j = jpq.pq_train(jnp.asarray(X), M=8, key=key, kmeans_iters=10)
    cb_t = tpq.pq_train(torch.from_numpy(X), M=8, kmeans_iters=10,
                        init_centers=torch.from_numpy(_jax_seedings(X, 8, key)), device="cpu")
    return X, cb_j, cb_t


def test_codebooks_and_codes_match_jax(trained):
    X, cb_j, cb_t = trained
    assert (cb_t.M, cb_t.dsub) == (cb_j.M, cb_j.dsub) == (8, 2)
    assert cb_t.codebooks.shape == (8, 256, 2) and cb_t.codebooks.dtype == torch.float32
    np.testing.assert_allclose(cb_t.codebooks.numpy(), np.asarray(cb_j.codebooks), atol=1e-5)
    codes_t = tpq.pq_encode(torch.from_numpy(X), cb_t, block=1000)
    codes_j = jpq.pq_encode(jnp.asarray(X), cb_j)
    assert codes_t.dtype == torch.uint8 and codes_t.shape == (X.shape[0], 8)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))


@pytest.fixture(scope="module")
def jax_codebook():
    """The JAX package's codebook and codes of TestPQ-like data, and the
    codebook carried into the port."""
    X = _clustered(2000)
    cb_j = jpq.pq_train(jnp.asarray(X[:1500]), M=8, key=jax.random.PRNGKey(1), kmeans_iters=5)
    cb_t = tpq.PQCodebook(torch.from_numpy(np.array(cb_j.codebooks)), cb_j.M, cb_j.dsub)
    return X, cb_j, cb_t, jpq.pq_encode(jnp.asarray(X), cb_j)


@pytest.mark.parametrize("kw", [dict(), dict(block=100, db_chunk=700), dict(exclude=True)])
def test_adc_search_matches_jax(jax_codebook, kw):
    """ADC from one codebook (the JAX package's, carried across): query
    blocks and database chunks of other sizes leave the result as it is."""
    X, cb_j, cb_t, codes = jax_codebook
    kw = dict(kw)
    rows = np.arange(X.shape[0], dtype=np.int32) if kw.pop("exclude", False) else None
    want = jpq.pq_search(jnp.asarray(X[:400]), codes, cb_j, k=10,
                         exclude_rows=None if rows is None else jnp.asarray(rows[:400]))
    got = tpq.pq_search(torch.from_numpy(X[:400]), torch.from_numpy(np.array(codes)), cb_t, k=10,
                        exclude_rows=None if rows is None else torch.from_numpy(rows[:400]), **kw)
    assert_same_up_to_ties(*got, *want)


@pytest.mark.parametrize("refine", [False, True])
def test_pq_knn_matches_jax(refine):
    """The whole ``pq_knn`` from the JAX package's draws: its train rows and
    every subspace's seeding. With ``refine_from`` the distances are exact
    squared distances of the re-ranked candidates."""
    X = _grid(per_point=10, seed=2)
    key = jax.random.PRNGKey(0)
    train_rows = np.asarray(jax.random.choice(key, X.shape[0], (2048,), replace=False))
    seeds = _jax_seedings(X[train_rows], 8, key)
    kw = dict(k=8, M=8, train_size=2048)
    ref = dict(refine_from=X, refine_factor=4) if refine else {}
    want = jpq.pq_knn(jnp.asarray(X), key=key, **kw,
                      **({"refine_from": jnp.asarray(X), "refine_factor": 4} if refine else {}))
    got = tpq.pq_knn(torch.from_numpy(X), train_rows=train_rows,
                     init_centers=torch.from_numpy(seeds), **kw,
                     **({k: torch.from_numpy(v) if k == "refine_from" else v
                         for k, v in ref.items()}))
    assert_same_up_to_ties(*got, *want)


def test_recall_in_reference_band_and_refine_recovers():
    """``TestPQ``'s gate on the port: ADC recall above 0.10, and the refined
    search 0.1 above it."""
    X = torch.from_numpy(_clustered(6000))
    _, i0 = knn_graph(X, k=10)

    def recall(i):
        return float((i0[:1000, :, None] == i[:1000, None, :]).any(-1).float().mean())

    r_adc = recall(tpq.pq_knn(X, k=10, M=8)[1])
    r_ref = recall(tpq.pq_knn(X, k=10, M=8, refine_from=X, refine_factor=8)[1])
    assert r_adc > 0.10
    assert r_ref > r_adc + 0.1


def test_no_self_matches_and_shapes():
    X = torch.from_numpy(_clustered(2000))
    d, i = tpq.pq_knn(X, k=5, M=8)
    assert d.shape == i.shape == (2000, 5) and i.dtype == torch.int32
    assert not bool((i == torch.arange(2000)[:, None]).any())
    assert bool((d[:, 1:] >= d[:, :-1]).all())


def test_indivisible_d_raises():
    with pytest.raises(ValueError, match="divisible"):
        tpq.pq_train(torch.zeros((300, 30)), M=8)


def test_numpy_input_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpq.pq_train(np.zeros((300, 32), np.float32), M=8)


def test_exact_reference_of_the_refined_distances():
    """The refined distances are the exact squared distances of the ids
    they name (float64 reference)."""
    X = _clustered(1500, seed=4)
    d, i = tpq.pq_knn(torch.from_numpy(X), k=6, M=8, refine_from=torch.from_numpy(X))
    Xd = X.astype(np.float64)
    exact = ((Xd[:, None, :] - Xd[i.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), exact, rtol=1e-5, atol=1e-4)
    _, i_ex = jax_knn_graph(jnp.asarray(X), k=6)
    assert float((np.asarray(i_ex)[:, :, None] == i.numpy()[:, None, :]).any(-1).mean()) > 0.5
