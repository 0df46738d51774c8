"""The IVF tier of the PyTorch port (torchdr_tpu_torch/ops/ivf.py) against
the JAX package.

Builds: the same data, train sample and k-means seeding go through both
packages' ``ivf_build``; the JAX package draws with its PRNG, so the port
is handed those draws (``train_idx``, ``init_centers``, ``super_init``).
The layouts (``ids_sorted``, ``offsets``, ``counts``, ``cells_sorted``,
``super_members``) are equal, ``cell_adj`` too but for the order of cells
equidistant within 1e-5, ``X_sorted`` is the same permutation bit for bit,
and the centroids agree to 1e-5.

Searches: one JAX index is carried into the port (``index_from_numpy``) and
searched by both packages. Indices are equal up to ties (a position may
differ only where the distance equals another of the row's within 1e-6
relative, or sits at the k-th place); distances agree to 1e-5 absolute plus
1e-5 relative. With ``rerank=False`` the distances are float32 assemblies
|x|² − 2q·x + |q|², whose rounding is relative to the norms they cancel,
not to the distance: there the relative part is taken of |q|² + |x|², and
two distances tie within 2e-5 of it. The merge, rerank, nomination and
budget-order cases form a pairwise covering set: every value of each, and
every pair of values of two of them, is searched.

The data are well conditioned for float32: the gram form rounds at
~|q|²·2⁻²³, and a near-tie at that scale flips a k-means assignment or a
probe choice, after which the two runs part ways. Each fixture says how it
avoids that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu.ops import ivf as jivf
from torchdr_tpu.ops.kmeans import _plus_plus_init as jax_plus_plus_init
from torchdr_tpu.ops.kmeans import kmeans_fit as jax_kmeans_fit
from torchdr_tpu_torch.ops import ivf as tivf
from torchdr_tpu_torch.ops.distance import knn_graph

LAYOUT = ("ids_sorted", "offsets", "counts", "cells_sorted", "cell_adj", "super_members")


def _clustered(n, d, n_clusters, seed, scale=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def searched():
    """One JAX index at nlist = 300 (so it has a cell table for adjacency
    nomination), its port, and the data: overlapping clusters, centred. The
    float32 gram form |q|² + |c|² − 2q·c rounds at ~|q|²·2⁻²³; with the
    norms near the distances, no query's probe set hangs on that rounding
    (on clusters at scale 8 some rows' did)."""
    X = _clustered(6000, 12, 30, seed=0, scale=2.0)
    X -= X.mean(0)
    jindex = jivf.ivf_build(jnp.asarray(X), n_clusters=300, kmeans_iters=8, chunk=64)
    assert jindex.cell_adj is not None
    return X, jindex, tivf.index_from_numpy(jindex, "cpu")


def _tight(groups, per_group, per_cluster, d, seed):
    """Rows in tight clusters (noise 0.05), the clusters in well-separated
    groups, sorted by cluster: k-means from one seeding then has no row near
    a cell boundary, so both packages' float32 Lloyd steps agree exactly."""
    rng = np.random.default_rng(seed)
    g = rng.normal(scale=20.0, size=(groups, d))
    c = np.repeat(g, per_group, 0) + rng.normal(scale=4.0, size=(groups * per_group, d))
    X = np.repeat(c, per_cluster, 0) + rng.normal(scale=0.05, size=(len(c) * per_cluster, d))
    return X.astype(np.float32)


def _composite(seed, d=12, n_top=16, n_fat=4, subs=4, per=60):
    """16 well-separated clusters, 4 of them three times as heavy and each
    made of 4 tight sub-clusters: the balance split cuts those 4 cells along
    their sub-clusters."""
    rng = np.random.default_rng(seed)
    top = rng.normal(scale=20.0, size=(n_top, d))
    rows = []
    for t in range(n_top):
        k, m = (subs, 3 * per) if t < n_fat else (1, per)
        centers = top[t] + (rng.normal(scale=4.0, size=(k, d)) if k > 1 else 0.0)
        rows += [c + rng.normal(scale=0.05, size=(m, d)) for c in centers]
    return np.concatenate(rows).astype(np.float32)


def assert_same_neighbours(got_d, got_i, want_d, want_i, Q=None, X=None):
    """``Q`` and ``X`` (the queries and the database, rows in id order) mark
    scan-score distances: the relative tolerance then applies to the
    norms."""
    got_d, got_i = np.asarray(got_d, np.float64), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d, np.float64), np.asarray(want_i)
    assert got_i.dtype == np.int32 and want_i.dtype == np.int32
    assert got_i.shape == want_i.shape
    scale = np.abs(want_d)
    tie_tol = 1e-6 * np.maximum(1.0, scale)
    if X is not None:
        norms = lambda A: (A.astype(np.float64) ** 2).sum(1)  # noqa: E731
        scale = np.maximum(scale, norms(Q)[:, None] + norms(X)[np.maximum(want_i, 0)])
        tie_tol = 2e-5 * scale  # two scan scores within their rounding
    assert np.all(np.abs(got_d - want_d) <= 1e-5 + 1e-5 * scale)
    k = want_i.shape[1]
    for r, j in zip(*np.nonzero(got_i != want_i)):
        tie = np.abs(want_d[r] - want_d[r, j]) <= tie_tol[r, j]
        assert j == k - 1 or tie.sum() > 1, (r, j, got_i[r], want_i[r], want_d[r])
    assert (got_i != want_i).mean() < 1e-3


COVER = [  # merge, rerank, nomination, budget_order: a pairwise covering set
    ("approx", True, "flat", "depth"),
    ("approx", False, "adjacency", "rank"),
    ("exact", True, "adjacency", "rank"),
    ("exact", False, "flat", "depth"),
    ("tournament", True, "flat", "rank"),
    ("tournament", False, "adjacency", "depth"),
]


@pytest.mark.parametrize("merge, rerank, nomination, budget_order", COVER)
def test_search_matches_jax(searched, merge, rerank, nomination, budget_order):
    _, jindex, tindex = searched
    kw = dict(k=10, nprobe=8, merge=merge, rerank=rerank, nomination=nomination,
              budget_order=budget_order)
    want = jivf.ivf_knn(None, index=jindex, **kw)
    got = tivf.ivf_knn(None, index=tindex, **kw)
    X = searched[0]
    assert_same_neighbours(*got, *want, *((X, X) if not rerank else ()))


@pytest.mark.parametrize("extra", [
    dict(seg_rows=1000),  # the search in segments of 1000 queries
    dict(budget=6, budget_order="rank"),  # a budget below the probed cells' chunks
    dict(exclude_self=False, merge="exact"),
    dict(scoring="asymmetric"),
    dict(block=128, nomination="adjacency"),
])
def test_search_options_match_jax(searched, extra):
    X, jindex, tindex = searched
    kw = dict(k=10, nprobe=8, **extra)
    Xin = X if extra.get("scoring") == "asymmetric" else None
    want = jivf.ivf_knn(None if Xin is None else jnp.asarray(Xin), index=jindex, **kw)
    got = tivf.ivf_knn(None if Xin is None else torch.from_numpy(Xin), index=tindex, **kw)
    assert_same_neighbours(*got, *want)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(nomination="adjacency", rerank=False),
    dict(sort_queries=False, merge="tournament"),
    dict(with_ids=True, merge="exact"),
])
def test_queries_match_jax(searched, kw):
    X, jindex, tindex = searched
    kw = dict(kw)
    Q = X[::7] + np.float32(0.01)
    if kw.pop("with_ids", False):
        kw["query_ids"] = np.arange(0, X.shape[0], 7, dtype=np.int32)
    want = jivf.ivf_knn_queries(jnp.asarray(Q), jindex, k=10, nprobe=4, **kw)
    got = tivf.ivf_knn_queries(torch.from_numpy(Q), tindex, k=10, nprobe=4, **kw)
    assert_same_neighbours(*got, *want, *((Q, X) if kw.get("rerank") is False else ()))


def test_adjacency_samples_home_cells_as_the_jax_package_does(searched):
    """Blocks of 48 rows over chunks of 64: half of them straddle two cells.
    Both packages sample each block's home cell at its first row only
    (max(1, block // chunk) = 1 sample), so the port equals the JAX package
    on every row, the straddling blocks included."""
    X, jindex, tindex = searched
    kw = dict(k=10, nprobe=8, block=48, nomination="adjacency")
    assert jindex.chunk == 64
    cells = np.asarray(jindex.cells_sorted)
    n_total = len(np.asarray(jindex.ids_sorted)) - jindex.chunk
    starts = np.arange(0, n_total, 48)
    straddle = cells[starts] != cells[np.minimum(starts + 47, n_total - 1)]
    assert straddle.sum() >= 10
    want = jivf.ivf_knn(None, index=jindex, **kw)
    got = tivf.ivf_knn(None, index=tindex, **kw)
    assert_same_neighbours(*got, *want)


def test_batched_blocks_equal_one_block_at_a_time(searched, monkeypatch):
    """The port runs many query blocks as one batched step; run one at a
    time (the unbatched form), the results are bit for bit the same."""
    _, _, tindex = searched
    kw = dict(k=10, nprobe=8, nomination="adjacency", merge="tournament")
    many = tivf.ivf_knn(None, index=tindex, **kw)
    monkeypatch.setattr(tivf, "_group_size", lambda *a: 1)
    one = tivf.ivf_knn(None, index=tindex, **kw)
    assert torch.equal(many[0], one[0]) and torch.equal(many[1], one[1])


@pytest.mark.parametrize("scan_impl", ["slices", "rows"])
def test_scan_impls_give_the_same_results(searched, scan_impl):
    _, _, tindex = searched
    a = tivf.ivf_knn(None, index=tindex, k=10, nprobe=8)
    b = tivf.ivf_knn(None, index=tindex, k=10, nprobe=8, scan_impl=scan_impl)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kw", [
    dict(scan_precision="default"), dict(scan_precision="highest"), dict(scan_fidelity="hi"),
])
def test_precision_and_fidelity_give_the_same_results(searched, kw):
    """Every product is float32 whatever ``scan_precision`` names, and float32
    storage has no residual plane for ``scan_fidelity="hi"`` to drop."""
    X, _, tindex = searched
    for search in (lambda **o: tivf.ivf_knn(None, index=tindex, k=10, nprobe=8, **o),
                   lambda **o: tivf.ivf_knn_queries(torch.from_numpy(X[::7]), tindex, k=10,
                                                    nprobe=4, **o)):
        a, b = search(), search(**kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_recall_against_exact():
    """The JAX package's own recall test on the port (its data, nlist and
    nprobe): recall@10 > 0.98, and no row returns itself."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(20, 16)).astype(np.float32)
    X = centers[rng.integers(0, 20, 4000)] + rng.normal(size=(4000, 16)).astype(np.float32)
    _, i0 = knn_graph(torch.from_numpy(X), k=10)
    _, i1 = tivf.ivf_knn(torch.from_numpy(X), k=10, nprobe=8, n_clusters=32)
    rec = (i0[:, :, None] == i1[:, None, :]).any(-1).float().mean()
    assert float(rec) > 0.98
    assert not bool((i1 == torch.arange(X.shape[0])[:, None]).any())


def _jax_pre_relabel_centroids(X, nlist, key, kmeans_iters, train_idx=None):
    train = X if train_idx is None else X[np.asarray(train_idx)]
    init = "random" if nlist >= 2048 else "++"
    return jax_kmeans_fit(jnp.asarray(train), nlist, key, max_iter=kmeans_iters, init=init)[0]


def _jax_seeding(train, n_clusters, key, init):
    train = jnp.asarray(train)
    if init == "random":
        stride = max(1, train.shape[0] // n_clusters)
        start = int(jax.random.randint(key, (), 0, jnp.asarray(stride)))
        return np.array(train[start + stride * np.arange(n_clusters)])
    return np.array(jax_plus_plus_init(train, jnp.sum(train * train, -1), n_clusters, key))


BUILDS = {
    "flat": dict(n=3000, d=12, clusters=20, kw=dict(n_clusters=24, kmeans_iters=8)),
    "supers relabel": dict(n=3000, d=12, clusters=20,
                           kw=dict(n_clusters=24, kmeans_iters=8, n_superlist=6)),
    "balance_extra": dict(data=lambda: _composite(0),
                          kw=dict(n_clusters=16, kmeans_iters=8, balance_extra=6)),
    "cell table": dict(data=lambda: _tight(10, 30, 20, 12, 0),
                       kw=dict(n_clusters=300, kmeans_iters=8, chunk=64)),
    "train sample": dict(n=3000, d=12, clusters=20, kw=dict(n_clusters=16, kmeans_iters=8,
                                                           train_size=1200)),
    "random seeding, supers, cell table": dict(data=lambda: _tight(32, 64, 8, 8, 1),
                                                kw=dict(n_clusters=2048, kmeans_iters=5)),
    "unaligned": dict(n=3000, d=12, clusters=20, kw=dict(n_clusters=24, kmeans_iters=8,
                                                        align=False)),
}


def assert_same_adjacency(got, want, centroids):
    """Equal nearest-cell lists, but for the order of two cells whose
    distances (in float64) are within 1e-5 relative: the float32 gram
    rounds at ~2e-6 of them here."""
    assert got.dtype == np.int32 and got.shape == want.shape
    c = centroids.astype(np.float64)
    for r in np.nonzero((got != want).any(1))[0]:
        assert set(got[r]) == set(want[r]), r
        d = ((c[want[r]] - c[r]) ** 2).sum(1)
        for j in np.nonzero(got[r] != want[r])[0]:
            assert (np.abs(d - d[j]) <= 1e-5 * d[j]).sum() > 1, (r, j)


@pytest.mark.parametrize("case", list(BUILDS))
def test_build_matches_jax(case):
    spec = BUILDS[case]
    X = spec["data"]() if "data" in spec else _clustered(spec["n"], spec["d"], spec["clusters"], 3)
    kw = spec["kw"]
    n, nlist = X.shape[0], kw["n_clusters"]
    key = jax.random.PRNGKey(0)
    jindex = jivf.ivf_build(jnp.asarray(X), **kw)

    train_size = min(n, max(kw.get("train_size", 25_600), 64 * nlist))
    train_idx = None
    if n > train_size:
        # the rows jax.random.choice(key, X, ...) takes
        train_idx = np.asarray(jax.random.choice(key, n, (train_size,), replace=False))
    train = X if train_idx is None else X[train_idx]
    init = "random" if nlist >= 2048 else "++"
    init_centers = _jax_seeding(train, nlist, key, init)
    super_init = None
    n_super = kw.get("n_superlist", max(32, nlist // 64) if nlist >= 1024 else 0)
    if n_super and n_super < nlist:
        cent = _jax_pre_relabel_centroids(X, nlist, key, kw["kmeans_iters"], train_idx)
        super_init = _jax_seeding(np.asarray(cent), n_super, jax.random.fold_in(key, 7),
                                  "random" if n_super >= 2048 else "++")
    tindex = tivf.ivf_build(torch.from_numpy(X), train_idx=train_idx,
                            init_centers=torch.from_numpy(init_centers),
                            super_init=None if super_init is None else torch.from_numpy(super_init),
                            **kw)

    assert (tindex.chunk, tindex.n) == (jindex.chunk, jindex.n)
    if kw.get("balance_extra"):
        assert tindex.centroids.shape[0] > nlist  # the split happened
    for name in LAYOUT:
        want, got = getattr(jindex, name), getattr(tindex, name)
        assert (want is None) == (got is None), name
        if want is not None and name == "cell_adj":
            assert_same_adjacency(got.numpy(), np.asarray(want), np.asarray(jindex.centroids))
        elif want is not None:
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(tindex.X_sorted.numpy(), np.asarray(jindex.X_sorted))
    np.testing.assert_allclose(tindex.centroids.numpy(), np.asarray(jindex.centroids), atol=1e-5)
    if jindex.super_centroids is not None:
        np.testing.assert_allclose(tindex.super_centroids.numpy(),
                                   np.asarray(jindex.super_centroids), atol=1e-5)


@pytest.mark.parametrize("path", ["tensor", "host segments"])
def test_host_build_matches_device_build(path, monkeypatch):
    """A numpy dataset builds the same index as the same rows as a tensor:
    pushed whole when it fits the device, or assigned in pushed segments
    and permuted on the host when it does not (forced here by a budget of
    0 and segments of 500 rows). The k-means sample and the balance split
    ride along."""
    X = _clustered(3000, 12, 20, seed=4)
    kw = dict(n_clusters=20, kmeans_iters=8, train_size=1000, balance_extra=6)

    def build(Xin):
        g = torch.Generator()
        g.manual_seed(0)
        return tivf.ivf_build(Xin, generator=g, device="cpu", **kw)

    ref = build(torch.from_numpy(X))
    if path == "host segments":
        monkeypatch.setattr(tivf, "_permute_hbm_budget", lambda device: 0)
        monkeypatch.setattr(tivf, "_HOST_SEG_ROWS", 500)
    got = build(X)
    for name in tivf.IVFIndex._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


def test_index_from_numpy_round_trip(searched):
    _, jindex, tindex = searched
    again = tivf.index_from_numpy({k: v for k, v in tindex._asdict().items()}, "cpu")
    for name in tivf.IVFIndex._fields:
        a, b = getattr(tindex, name), getattr(again, name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), name
    assert tindex.ids_sorted.dtype == torch.int32 and tindex.centroids.dtype == torch.float32


def test_index_from_numpy_defaults_to_the_card(searched):
    """Like every entry point, ``index_from_numpy`` runs on the card unless
    told otherwise: with no device given it raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    _, jindex, _ = searched
    with pytest.raises(RuntimeError, match="CUDA"):
        tivf.index_from_numpy(jindex)


def test_auto_nlist_and_balance_allocate_match_jax():
    for n in (100, 6000, 100_000, 1_300_000, 10**8):
        assert tivf.auto_nlist(n) == jivf.auto_nlist(n)
    assert tivf.auto_nlist(1_300_000) == 4560
    counts = np.array([1000, 100, 100, 1], np.int64)
    np.testing.assert_array_equal(tivf._balance_allocate(counts, 9),
                                  jivf._balance_allocate(counts, 9))


def test_resolved_knobs_match_jax(searched):
    _, jindex, tindex = searched
    for kw in (dict(), dict(rerank=False), dict(merge="tournament"), dict(m=40, budget=5)):
        args = (10, 8, kw.get("m"), kw.get("budget"), kw.get("merge"), "xla")
        want = jivf._resolve_search_knobs(jindex, *args, rerank=kw.get("rerank", True))
        got = tivf._resolve_search_knobs(tindex, *args, rerank=kw.get("rerank", True))
        assert got == want


@pytest.mark.parametrize("call, exc, match", [
    (lambda X, i: tivf.ivf_knn(None, index=i, k=5, scan_impl="pallas"), ValueError, "scan_impl"),
    (lambda X, i: tivf.ivf_build(X, n_clusters=16, storage="f16"), ValueError, "storage"),
    (lambda X, i: tivf.ivf_build(X, n_clusters=16, storage="int8", align=False),
     ValueError, "align"),
    (lambda X, i: tivf.ivf_knn(None, index=i, k=5, scan_precision="low"),
     ValueError, "scan_precision"),
    (lambda X, i: tivf.ivf_knn(None, index=i, k=5, scan_fidelity="lo"),
     ValueError, "scan_fidelity"),
    (lambda X, i: tivf.ivf_knn_queries(X[:10], i, k=5, scan_fidelity="lo"),
     ValueError, "scan_fidelity"),
    (lambda X, i: tivf.ivf_knn(None, index=None, k=5), ValueError, "prebuilt index"),
    (lambda X, i: tivf.ivf_knn(None, index=i, k=5, scoring="asymmetric"), ValueError, "needs X"),
])
def test_error_paths(searched, call, exc, match):
    X, _, tindex = searched
    with pytest.raises(exc, match=match):
        call(torch.from_numpy(X[:1000]), tindex)


@pytest.mark.parametrize("case", [
    "storage split", "storage int8", "auto past split_bytes", "nomination supers",
    "nprobe_supers",
])
def test_tiers_once_refused_now_run(searched, case):
    """The five calls that raised ``NotImplementedError`` before the split,
    int8 and supers tiers were ported now build and search: the tier's
    planes have their dtypes, and the search finds nine in ten of the float32
    index's neighbours."""
    X, _, tindex = searched
    Xt = torch.from_numpy(X[:1000])
    want = tivf.ivf_knn(None, index=tivf.ivf_build(Xt, n_clusters=16, device="cpu"), k=5)[1]
    if case.startswith("nomination") or case == "nprobe_supers":
        kw = dict(nomination="supers") if case.startswith("nomination") else dict(nprobe_supers=4)
        index = tivf.ivf_build(Xt, n_clusters=16, n_superlist=4, device="cpu")
        got = tivf.ivf_knn(None, index=index, k=5, **kw)[1]
    else:
        kw = {"storage split": dict(storage="split"), "storage int8": dict(storage="int8"),
              "auto past split_bytes": dict(split_bytes=1)}[case]
        index = tivf.ivf_build(Xt, n_clusters=16, device="cpu", **kw)
        if index.scales is not None:
            assert index.X_sorted.dtype == torch.int8 and index.X_lo is None
        else:
            assert index.X_sorted.dtype == index.X_lo.dtype == torch.bfloat16
        assert index.xnorm2.dtype == torch.float32
        got = tivf.ivf_knn(None, index=index, k=5)[1]
    assert float((want[:, :, None] == got[:, None, :]).any(-1).float().mean()) > 0.9


def test_non_euclidean_metric_raises_in_the_affinity():
    from torchdr_tpu_torch import UMAPAffinity

    X = _clustered(300, 8, 4, seed=5)
    with pytest.raises(ValueError, match="euclidean"):
        UMAPAffinity(n_neighbors=10, metric="manhattan", knn_mode="ivf", device="cpu")(X)
