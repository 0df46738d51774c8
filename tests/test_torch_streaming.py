"""kNN graphs from batch feeds in the PyTorch port (torchdr_tpu_torch/ops/
streaming.py, ``ops/ivf.ivf_build_from_batches``): the cases of
``tests/test_streaming.py`` and ``tests/test_streaming_ivf.py`` on the
port, and the JAX package's functions beside the port's on the same feeds.

The exact tier's ids are held equal up to ties (a slot may differ only
where its distance equals another of the row's within 1e-6 relative, or
sits at the k-th place): the float32 gram of another query block may round
the last bit and reorder equal distances. The batch-built index from the
JAX package's draws (the seed of its numpy sample, its k-means seeding) has
the JAX layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu.ops import ivf as jivf
from torchdr_tpu.ops import streaming as jstreaming
from torchdr_tpu.ops.kmeans import _plus_plus_init as jax_plus_plus_init
from torchdr_tpu_torch.ops import ivf as tivf
from torchdr_tpu_torch.ops.distance import knn_graph
from torchdr_tpu_torch.ops.streaming import knn_graph_from_batches, knn_graph_streaming
from torchdr_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=5.0, size=(4, 8))
    return np.concatenate([c + rng.normal(size=(50, 8)) for c in centers]).astype(np.float32)


def _split(X, sizes):
    out, i = [], 0
    for s in sizes:
        out.append(X[i : i + s])
        i += s
    assert i == X.shape[0]
    return out


def graph(batches, **kw):
    return knn_graph_from_batches(batches, device="cpu", **kw)


def assert_same_up_to_ties(got_d, got_i, want_d, want_i, atol=1e-5):
    got_d, got_i = np.asarray(got_d, np.float64), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d, np.float64), np.asarray(want_i)
    assert got_i.shape == want_i.shape
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=atol)
    k = want_i.shape[1]
    for r, j in zip(*np.nonzero(got_i != want_i)):
        tie = np.abs(want_d[r] - want_d[r, j]) <= 1e-6 * max(1.0, abs(want_d[r, j]))
        assert j == k - 1 or tie.sum() > 1, (r, j, got_i[r], want_i[r])


@pytest.mark.parametrize("sizes", [(200,), (100, 100), (64, 64, 64, 8), (1, 99, 100)])
def test_same_result_any_batching(X, sizes):
    d, i = graph(_split(X, sizes), k=7)
    d_ref, i_ref = graph([X], k=7)
    assert_same_up_to_ties(d, i, d_ref, i_ref)


def test_matches_monolithic_knn_graph_and_jax(X):
    batches = _split(X, (80, 80, 40))
    d, i = graph(batches, k=5)
    assert i.dtype == torch.int32
    assert_same_up_to_ties(d, i, *knn_graph(torch.from_numpy(X), k=5))
    # two gram forms |q|² + |x|² − 2q·x (|x|² ~ 200 here), each rounded at ~|x|²·2⁻²³
    assert_same_up_to_ties(d, i, *jstreaming.knn_graph_from_batches(batches, k=5), atol=3e-4)


def test_self_absent_when_excluded(X):
    _, i = graph(_split(X, (100, 100)), k=6)
    assert not bool((i == torch.arange(X.shape[0])[:, None]).any())


def test_self_first_when_included(X):
    d, i = graph(_split(X, (100, 100)), k=6, exclude_self=False)
    assert torch.equal(i[:, 0], torch.arange(X.shape[0], dtype=torch.int32))
    assert bool((d[:, 0].abs() <= 1e-3).all())  # the gram form: ~0, not exactly 0


def test_duplicate_rows_survive_exclusion():
    """Only the row's own id is stripped: a duplicate at another id stays
    its nearest neighbour at distance 0."""
    Xd = np.random.default_rng(0).normal(size=(30, 5)).astype(np.float32)
    Xd[17] = Xd[3]
    d, i = graph([Xd[:15], Xd[15:]], k=3)
    assert int(i[3, 0]) == 17 and int(i[17, 0]) == 3
    assert float(d[3, 0]) == 0.0 and float(d[17, 0]) == 0.0


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan", "angular"])
def test_metric_consistency(X, metric):
    d, i = graph(_split(X, (128, 72)), k=4, metric=metric)
    assert_same_up_to_ties(d, i, *knn_graph(torch.from_numpy(X), k=4, metric=metric),
                           atol=1e-4)


def test_unknown_metric_raises(X):
    with pytest.raises(ValueError, match="not supported"):
        graph([X], k=3, metric="mahalanobis")


def test_tuple_batches_and_torch_dataloader(X):
    from torch.utils.data import DataLoader, TensorDataset

    y = np.zeros(X.shape[0], np.int32)
    ref = graph([X], k=5)
    assert_same_up_to_ties(*graph([(X[:100], y[:100]), (X[100:], y[100:])], k=5), *ref)
    loader = DataLoader(TensorDataset(torch.from_numpy(X), torch.zeros(X.shape[0])),
                        batch_size=64, shuffle=False)
    assert_same_up_to_ties(*graph(loader, k=5), *ref)


def test_generator_single_pass(X):
    calls = []

    def gen():
        for b in _split(X, (64, 64, 72)):
            calls.append(1)
            yield b

    got = graph(gen(), k=4)
    assert len(calls) == 3
    assert_same_up_to_ties(*got, *graph([X], k=4))


def test_float64_batches_are_cast(X):
    d, i = graph([X.astype(np.float64)], k=3)
    assert d.dtype == torch.float32
    assert_same_up_to_ties(d, i, *graph([X], k=3))


def test_boundaries_and_errors(X):
    with pytest.raises(ValueError, match="empty"):
        graph([], k=3)
    Xs = np.random.default_rng(1).normal(size=(12, 4)).astype(np.float32)
    _, i = graph([Xs[:6], Xs[6:]], k=11)
    for r in range(12):  # each row sees every other row once
        assert sorted(i[r].tolist()) == [j for j in range(12) if j != r]
    d, i = graph([X[j : j + 1] for j in range(20)], k=3)
    assert_same_up_to_ties(d, i, *graph([X[:20]], k=3))
    d, i = graph(_split(X, (150, 50)), k=9)
    assert d.shape == i.shape == (X.shape[0], 9) and bool((d >= 0).all())


def test_mesh_branch_equals_the_single_device_graph(X):
    mesh = make_mesh(devices=["cpu"] * 4)
    got = knn_graph_from_batches(_split(X, (80, 80, 40)), k=5, mesh=mesh)
    want = graph(_split(X, (80, 80, 40)), k=5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# --- the batch-built IVF index and the segmented search ---


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=8.0, size=(24, 12))
    Xd = np.concatenate([c + rng.normal(size=(150, 12)) for c in centers]).astype(np.float32)
    rng.shuffle(Xd)  # batches must not align with clusters
    return Xd, knn_graph(torch.from_numpy(Xd), k=10)[1].numpy()


def recall(i_true, i_test):
    return float((np.asarray(i_true)[:, :, None] == np.asarray(i_test)[:, None, :]).any(-1).mean())


def _tight(seed=0):
    """Tight clusters (noise 0.05) in well-separated groups, shuffled: no
    row near a cell boundary, so both packages' float32 Lloyd steps agree."""
    rng = np.random.default_rng(seed)
    g = rng.normal(scale=20.0, size=(6, 12))
    c = np.repeat(g, 2, 0) + rng.normal(scale=4.0, size=(12, 12))
    Xt = (np.repeat(c, 100, 0) + rng.normal(scale=0.05, size=(1200, 12))).astype(np.float32)
    return Xt[rng.permutation(1200)]


def _jax_batch_draws(batches, n, nlist, key):
    """The global rows of the JAX package's training sample and its k-means
    seeding, as ``ivf_build_from_batches(batches, nlist, key)`` draws them."""
    train_size = min(n, max(25_600, 64 * nlist))
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 1 << 30)))
    rows, row0 = [], 0
    for b in batches:
        take = max(1, int(round(train_size * b.shape[0] / n)))
        rows.append(row0 + np.sort(rng.choice(b.shape[0], min(take, b.shape[0]), replace=False)))
        row0 += b.shape[0]
    rows = np.concatenate(rows)[:train_size]
    Xtr = jnp.asarray(np.concatenate(batches)[rows])
    return rows, np.array(jax_plus_plus_init(Xtr, jnp.sum(Xtr * Xtr, -1), nlist, key))


@pytest.mark.parametrize("storage", ["f32", "split", "int8"])
def test_build_from_batches_matches_jax(storage):
    Xt = _tight()
    batches = [Xt[a : a + 250] for a in range(0, 1200, 250)]
    key = jax.random.PRNGKey(0)
    j = jivf.ivf_build_from_batches(batches, n_clusters=12, kmeans_iters=8, storage=storage)
    rows, c0 = _jax_batch_draws(batches, 1200, 12, key)
    t = tivf.ivf_build_from_batches(batches, n_clusters=12, kmeans_iters=8, storage=storage,
                                    train_rows=rows, init_centers=torch.from_numpy(c0),
                                    device="cpu")
    for name in ("ids_sorted", "offsets", "counts", "cells_sorted"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-5)
    assert (t.X_lo is None) == (j.X_lo is None) and (t.scales is None) == (j.scales is None)
    if storage == "f32":
        np.testing.assert_array_equal(t.X_sorted.numpy(), np.asarray(j.X_sorted))
    else:  # planes of r = x − c, the centroids 1e-5 apart
        real = t.ids_sorted.numpy() >= 0
        got = t.X_sorted.float().numpy()[real]
        want = np.asarray(j.X_sorted).astype(np.float32)[real]
        assert np.mean(got == want) > 0.99
        np.testing.assert_allclose(t.xnorm2.numpy()[real], np.asarray(j.xnorm2)[real], rtol=1e-5)


def test_build_from_batches_equals_the_monolithic_build(data):
    """From the same sample and seeding, the batch-built index is the one
    ``ivf_build`` makes of the whole array."""
    Xd, _ = data
    batches = [Xd[a : a + 1000] for a in range(0, Xd.shape[0], 1000)]
    sample = np.arange(0, Xd.shape[0], 2)
    seeds = torch.from_numpy(Xd[sample[:24] * 3 % Xd.shape[0]])
    kw = dict(n_clusters=24, kmeans_iters=8, init_centers=seeds, device="cpu")
    b = tivf.ivf_build_from_batches(batches, train_rows=sample, **kw)
    m = tivf.ivf_build(torch.from_numpy(Xd), train_idx=sample, train_size=sample.size, **kw)
    for name in ("centroids", "X_sorted", "ids_sorted", "offsets", "counts", "cells_sorted"):
        assert torch.equal(getattr(b, name), getattr(m, name)), name


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_tiers_from_batches_search(data, storage):
    Xd, i0 = data
    batches = [Xd[a : a + 1000] for a in range(0, Xd.shape[0], 1000)]
    extra = dict(split_bytes=1) if storage == "split" else dict(storage="int8")
    idx = tivf.ivf_build_from_batches(batches, n_clusters=24, device="cpu", **extra)
    assert idx.X_sorted.dtype == (torch.bfloat16 if storage == "split" else torch.int8)
    _, i = tivf.ivf_knn(None, k=10, nprobe=8, index=idx)
    assert recall(i0, i) > (0.97 if storage == "split" else 0.95)


def test_tuple_batches_and_torch(data):
    Xd, _ = data
    batches = [(torch.from_numpy(Xd[a : a + 1500].copy()), None)
               for a in range(0, Xd.shape[0], 1500)]
    assert tivf.ivf_build_from_batches(batches, n_clusters=16, device="cpu").n == Xd.shape[0]


def test_self_queries_match_the_self_path(data):
    Xd, i0 = data
    idx = tivf.ivf_build(torch.from_numpy(Xd), n_clusters=24)
    _, i_self = tivf.ivf_knn(None, k=10, nprobe=8, index=idx)
    _, i_q = tivf.ivf_knn_queries(torch.from_numpy(Xd), idx, k=10, nprobe=8,
                                  query_ids=np.arange(Xd.shape[0], dtype=np.int32))
    assert recall(i0, i_q) > recall(i0, i_self) - 0.02
    assert not bool((i_q == torch.arange(Xd.shape[0])[:, None]).any())


@pytest.mark.parametrize("split", [False, True])
def test_disjoint_queries(data, split):
    """Raw queries against an index of other rows; with the split and every
    cell probed, the residual-scored raw-query path is exact."""
    Xd, _ = data
    db = torch.from_numpy(Xd[:3000])
    idx = tivf.ivf_build(db, n_clusters=16, **(dict(split_bytes=1) if split else {}))
    assert (idx.X_lo is not None) == split
    Q = torch.from_numpy(Xd[3000:])
    _, i_q = tivf.ivf_knn_queries(Q, idx, k=5, nprobe=16 if split else 10)
    _, i0 = knn_graph(Q, db, k=5, exclude_diag=False)
    assert recall(i0, i_q) > (0.999 if split else 0.95)


def test_segments_match_the_single_index(data):
    """Three segments (seg_bytes just over two batches), each its own index,
    merged on the host: recall at the in-memory IVF tier's, ascending
    distances, no self match, and the time split into its three parts."""
    Xd, i0 = data
    batches = [Xd[a : a + 1000] for a in range(0, Xd.shape[0], 1000)]
    timings = {}
    d_s, i_s = knn_graph_streaming(batches, k=10, nprobe=8, n_clusters=8,
                                   seg_bytes=2 * 1000 * Xd.shape[1] * 4 + 1, device="cpu",
                                   timings=timings)
    assert i_s.dtype == np.int64 and d_s.dtype == np.float32
    idx = tivf.ivf_build(torch.from_numpy(Xd), n_clusters=24)
    _, i_m = tivf.ivf_knn(None, k=10, nprobe=8, index=idx)
    r = recall(i0, i_s)
    assert r > recall(i0, i_m) - 0.02 and r > 0.95
    assert (np.diff(d_s, axis=1) >= -1e-6).all()
    assert not (i_s == np.arange(Xd.shape[0])[:, None]).any()
    assert set(timings) == {"build_s", "query_s", "merge_s"}
    assert all(v > 0 for v in timings.values())


def test_single_segment_matches_jax(data):
    """One segment (the default seg_bytes holds the feed): the JAX package's
    streaming graph and the port's reach the same recall."""
    Xd, i0 = data
    batches = [Xd[a : a + 2000] for a in range(0, Xd.shape[0], 2000)]
    _, i_s = knn_graph_streaming(batches, k=10, nprobe=10, n_clusters=24, device="cpu")
    _, i_j = jstreaming.knn_graph_streaming(batches, k=10, nprobe=10, n_clusters=24)
    assert recall(i0, i_s) > 0.95
    assert abs(recall(i0, i_s) - recall(i0, i_j)) < 0.01


def test_inconsistent_replay_rejected(data):
    Xd, _ = data
    state = {"calls": 0}

    def flaky():
        state["calls"] += 1
        keep = None if state["calls"] == 1 else -1  # later passes lose a batch
        return iter([Xd[a : a + 1000] for a in range(0, Xd.shape[0], 1000)][:keep])

    with pytest.raises(ValueError, match="every pass"):
        tivf.ivf_build_from_batches(flaky, n_clusters=16, device="cpu")
