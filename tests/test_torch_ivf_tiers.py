"""The IVF storage tiers and supers nomination of the PyTorch port
(torchdr_tpu_torch/ops/ivf.py, parallel/ivf.py) against the JAX package.

Planes: the same float32 sorted rows, cells and centroids go through both
packages' tier functions. The bf16 split is equal bit for bit (both round
to nearest even); int8 codes are equal but where the two divisions r / s
fall on opposite sides of a .5 tie (under 1e-4 of the entries), scales and
norms equal within 1e-6 relative.

Searches: one JAX index of each tier (split, int8; 300 cells, so it has a
cell table, and 16 supers) is carried into the port by ``index_from_numpy``
and searched by both packages. The port's products are float32 where the
JAX package sums bf16 products for the split tier, and its exact top-k
replaces ``approx_min_k``, so the ids are held to agree on at least 0.99
of the (row, slot) pairs, and the distances of the agreeing pairs to 1e-4
relative.

Builds: the port's ``ivf_build`` on the JAX package's draws gives the JAX
layout, and rows that the stored planes rebuild within float32 rounding of
the JAX package's (the centroids agree to 1e-5, not bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread, warm_worker_threads  # noqa: F401
from torchdr_tpu.ops import ivf as jivf
from torchdr_tpu.ops.kmeans import _plus_plus_init as jax_plus_plus_init
from torchdr_tpu.parallel import ivf as jpivf
from torchdr_tpu.parallel import mesh as jmesh
from torchdr_tpu_torch.ops import ivf as tivf
from torchdr_tpu_torch.parallel.ivf import ivf_knn_sharded
from torchdr_tpu_torch.parallel.mesh import make_mesh

ID_AGREE = 0.99


def _clustered(n, d, n_clusters, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    lab = rng.integers(0, n_clusters, n)
    X = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    return X - X.mean(0)


@pytest.fixture(scope="module")
def data():
    return _clustered(6000, 12, 30, seed=0)


@pytest.fixture(scope="module")
def indexes(data):
    """{tier: (JAX index, its port)} at 300 cells (a cell table) and 16
    supers."""
    kw = dict(n_clusters=300, kmeans_iters=8, chunk=64, n_superlist=16)
    out = {}
    for tier, extra in (("split", dict(split_bytes=1)), ("int8", dict(storage="int8"))):
        j = jivf.ivf_build(jnp.asarray(data), **kw, **extra)
        out[tier] = (j, tivf.index_from_numpy(j, "cpu"))
    return out


@pytest.fixture(scope="module")
def f32_layout(data):
    """A float32 JAX index's sorted rows, cell table, centroids and ids."""
    j = jivf.ivf_build(jnp.asarray(data), n_clusters=40, kmeans_iters=8, chunk=64,
                       storage="f32")
    fields = [np.array(getattr(j, f)) for f in ("X_sorted", "cells_sorted", "centroids",
                                                "ids_sorted", "offsets")]
    return j, fields


def assert_agree(got, want):
    """Ids agree on ≥ ID_AGREE of the (row, slot) pairs; the distances of
    agreeing pairs within 1e-4 relative (1e-4 absolute below 1)."""
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(a) for a in want)
    assert gi.dtype == np.int32 and gi.shape == wi.shape
    same = gi == wi
    assert same.mean() >= ID_AGREE, same.mean()
    scale = np.maximum(1.0, np.abs(wd[same]))
    assert np.all(np.abs(gd[same] - wd[same]) <= 1e-4 * scale)


def test_bf16_split_rounds_as_the_jax_package_bit_for_bit():
    """Normal floats, ties of the hi rounding among them. (XLA's CPU flushes
    a subnormal lo plane to zero, where torch keeps it: |r| < ~1e-35.)"""
    rng = np.random.default_rng(1)
    r = np.concatenate([
        rng.normal(scale=s, size=20_000) for s in (1e-3, 1.0, 30.0, 1e4)
    ]).astype(np.float32)
    # halfway cases of the hi rounding (the dropped 16 bits exactly 0x8000)
    ties = (rng.integers(0, 1 << 16, 4000, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    ties = ties[np.isfinite(ties) & (np.abs(ties) > 1e-30)]
    r = np.concatenate([r, ties, [0.0, -0.0, -3e38]]).astype(np.float32)
    whi, wlo = jivf._bf16_split(jnp.asarray(r))
    ghi, glo = tivf._bf16_split(torch.from_numpy(r))
    for got, want in ((ghi, whi), (glo, wlo)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def test_residual_split_planes_match_jax(f32_layout):
    _, (Xs, cells, cent, _, _) = f32_layout
    whi, wlo, wxn = jivf._residual_split_device(jnp.asarray(Xs), jnp.asarray(cells),
                                                jnp.asarray(cent), seg_bytes=48 * 1024)
    ghi, glo, gxn = tivf._residual_split_device(torch.from_numpy(Xs), torch.from_numpy(cells),
                                                torch.from_numpy(cent), seg_bytes=48 * 1024)
    np.testing.assert_array_equal(ghi.view(torch.int16).numpy(), np.asarray(whi).view(np.int16))
    np.testing.assert_array_equal(glo.view(torch.int16).numpy(), np.asarray(wlo).view(np.int16))
    np.testing.assert_allclose(gxn.numpy(), np.asarray(wxn), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("where", ["device", "host"])
def test_int8_planes_match_jax(f32_layout, where):
    _, (Xs, cells, cent, ids, offs) = f32_layout
    if where == "device":
        want = jivf._int8_quantize_device(jnp.asarray(Xs), jnp.asarray(cells), jnp.asarray(cent),
                                          jnp.asarray(ids), seg_bytes=48 * 1024)
        got = tivf._int8_quantize_device(torch.from_numpy(Xs), torch.from_numpy(cells),
                                         torch.from_numpy(cent), torch.from_numpy(ids),
                                         seg_bytes=48 * 1024)
        got = [t.numpy() for t in got]
    else:
        offs = offs.astype(np.int64)
        want = jivf._int8_quantize_host(Xs.copy(), cells, cent, ids, offs)
        got = tivf._int8_quantize_host(Xs.copy(), cells, cent, ids, offs)
    (gq, gs, gxn), (wq, ws, wxn) = got, [np.asarray(a) for a in want]
    assert gq.dtype == np.int8 and gs.dtype == gxn.dtype == np.float32
    off = gq.astype(np.int32) - wq.astype(np.int32)
    assert np.abs(off).max() <= 1 and (off != 0).mean() < 1e-4
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    np.testing.assert_allclose(gxn, wxn, rtol=1e-6, atol=1e-6)


SEARCHES = {
    "split full": ("split", dict()),
    "split hi": ("split", dict(scan_fidelity="hi")),
    "split flat rerank=False": ("split", dict(nomination="flat", rerank=False)),
    "split adjacency": ("split", dict(nomination="adjacency", merge="approx")),
    "split supers": ("split", dict(nprobe_supers=6)),
    "int8 symmetric": ("int8", dict()),
    "int8 asymmetric": ("int8", dict(scoring="asymmetric", seg_rows=2048)),
    "int8 supers": ("int8", dict(nprobe_supers=6, nprobe=12)),
    "int8 adjacency, estimator settings": ("int8", dict(nomination="adjacency", rerank=False,
                                                        k=15)),
}


@pytest.mark.parametrize("case", list(SEARCHES))
def test_search_matches_jax(data, indexes, case):
    tier, kw = SEARCHES[case]
    kw = dict(dict(k=10, nprobe=8), **kw)
    j, t = indexes[tier]
    asym = kw.get("scoring") == "asymmetric"
    want = jivf.ivf_knn(jnp.asarray(data) if asym else None, index=j, **kw)
    got = tivf.ivf_knn(torch.from_numpy(data) if asym else None, index=t, **kw)
    assert_agree(got, want)


@pytest.mark.parametrize("tier", ["split", "int8"])
@pytest.mark.parametrize("kw", [dict(), dict(nomination="flat", scan_fidelity="hi")])
def test_raw_queries_match_jax(data, indexes, tier, kw):
    j, t = indexes[tier]
    Q = data[::5] + np.float32(0.01)
    want = jivf.ivf_knn_queries(jnp.asarray(Q), j, k=10, nprobe=4, **kw)
    got = tivf.ivf_knn_queries(torch.from_numpy(Q), t, k=10, nprobe=4, **kw)
    assert_agree(got, want)


@pytest.mark.parametrize("tier", ["split", "int8"])
@pytest.mark.parametrize("kw", [
    dict(), dict(nprobe_supers=6), dict(nprobe_supers=6, nomination="adjacency"),
    dict(nprobe_supers=2, nprobe=16), dict(rerank=False), dict(merge="approx"),
])
def test_resolved_knobs_match_jax(indexes, tier, kw):
    j, t = indexes[tier]
    args = (10, kw.get("nprobe", 8), None, None, kw.get("merge"), "xla",
            kw.get("nprobe_supers"), kw.get("nomination"))
    rerank = kw.get("rerank", True)
    assert tivf._resolve_search_knobs(t, *args, rerank=rerank) == \
        jivf._resolve_search_knobs(j, *args, rerank=rerank)


def test_supers_fall_back_when_the_union_is_too_thin(indexes):
    """Two supers' members (≤ 2 · W) cannot hold 60 probed cells: both
    packages search by flat nomination then, and agree."""
    j, t = indexes["split"]
    W = int(t.super_members.shape[1])
    assert 2 * W < 60
    kw = dict(k=10, nprobe=60, nprobe_supers=2)
    assert_agree(tivf.ivf_knn(None, index=t, **kw), jivf.ivf_knn(None, index=j, **kw))
    flat = tivf.ivf_knn(None, index=t, k=10, nprobe=60, nomination="flat")
    assert torch.equal(tivf.ivf_knn(None, index=t, **kw)[1], flat[1])


def _jax_draws(X, kw, key):
    """The train rows, k-means seeding and supers seeding that the JAX
    package's ``ivf_build(jnp.asarray(X), **kw)`` draws from ``key``."""
    n, nlist = X.shape[0], kw["n_clusters"]
    train_size = min(n, max(25_600, 64 * nlist))
    train_idx = (None if n <= train_size
                 else np.asarray(jax.random.choice(key, n, (train_size,), replace=False)))
    train = X if train_idx is None else X[train_idx]
    c0 = np.array(jax_plus_plus_init(jnp.asarray(train), jnp.sum(jnp.asarray(train) ** 2, -1),
                                     nlist, key))
    S = kw.get("n_superlist", 0)
    if not S:
        return train_idx, c0, None
    cent = jivf.kmeans_fit(jnp.asarray(train), nlist, key, max_iter=kw["kmeans_iters"])[0]
    s0 = np.array(jax_plus_plus_init(cent, jnp.sum(cent * cent, -1), S, jax.random.fold_in(key, 7)))
    return train_idx, c0, s0


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_build_matches_jax(storage):
    """The port's build of a tier from the JAX package's draws: the same
    layout, and stored rows within float32 rounding of the JAX package's
    (c + hi + lo, c + s·q)."""
    rng = np.random.default_rng(3)
    g = rng.normal(scale=20.0, size=(8, 12))
    X = (np.repeat(g, 250, 0) + rng.normal(scale=0.3, size=(2000, 12))).astype(np.float32)
    kw = dict(n_clusters=8, kmeans_iters=8, chunk=64, n_superlist=4)
    extra = dict(storage="int8") if storage == "int8" else dict(split_bytes=1)
    j = jivf.ivf_build(jnp.asarray(X), **kw, **extra)
    train_idx, c0, s0 = _jax_draws(X, kw, jax.random.PRNGKey(0))
    t = tivf.ivf_build(torch.from_numpy(X), train_idx=train_idx,
                       init_centers=torch.from_numpy(c0), super_init=torch.from_numpy(s0),
                       device="cpu", **kw, **extra)
    for name in ("ids_sorted", "offsets", "counts", "cells_sorted", "super_members"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-5)

    def rebuilt(index, numpy_of):
        cells = numpy_of(index.cells_sorted).astype(np.int64)
        rows = numpy_of(index.X_sorted).astype(np.float32)
        if index.scales is not None:
            rows = rows * numpy_of(index.scales)[cells]
        if index.X_lo is not None:
            rows = rows + numpy_of(index.X_lo).astype(np.float32)
        return rows + numpy_of(index.centroids)[cells]

    as_np = lambda a: (a.float().numpy() if isinstance(a, torch.Tensor)  # noqa: E731
                       else np.asarray(a, np.float32))
    real = t.ids_sorted.numpy() >= 0
    tol = 1e-4 if storage == "split" else 0.02  # an int8 step of a cell's scale, at most
    np.testing.assert_allclose(rebuilt(t, as_np)[real], rebuilt(j, as_np)[real], atol=tol)
    np.testing.assert_allclose(t.xnorm2.numpy()[real], np.asarray(j.xnorm2)[real], rtol=1e-3)


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_host_build_matches_device_build(storage, monkeypatch):
    """A numpy dataset too large for the device is permuted and tiered on
    the host: the same layout and the same real rows as the build on the
    tensor's device (the host int8 tier zeroes the pad rows' residual, as
    the JAX package's host path does)."""
    X = _clustered(3000, 12, 20, seed=4, scale=8.0)
    kw = dict(n_clusters=20, kmeans_iters=8, train_size=1000, storage=storage)

    def build(Xin):
        g = torch.Generator()
        g.manual_seed(0)
        return tivf.ivf_build(Xin, generator=g, device="cpu", **kw)

    ref = build(torch.from_numpy(X))
    monkeypatch.setattr(tivf, "_permute_hbm_budget", lambda device: 0)
    got = build(X)
    real = ref.ids_sorted >= 0
    for name in tivf.IVFIndex._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if not isinstance(a, torch.Tensor):
            assert a == b, name
        elif name == "xnorm2":  # einsum's sums on the host path
            np.testing.assert_allclose(b[real].numpy(), a[real].numpy(), rtol=1e-6)
        elif name in ("X_sorted", "X_lo"):
            assert a.dtype == b.dtype, name
            assert torch.equal(a[real], b[real]), name
        else:
            assert torch.equal(a, b), name


def test_index_from_numpy_keeps_the_tiers_dtypes(indexes):
    for tier, (j, t) in indexes.items():
        again = tivf.index_from_numpy(t, "cpu")
        for name in tivf.IVFIndex._fields:
            a, b = getattr(t, name), getattr(again, name)
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), (tier, name)
        plane = torch.int8 if tier == "int8" else torch.bfloat16
        assert t.X_sorted.dtype == plane
        np.testing.assert_array_equal(t.X_sorted.view(torch.int8 if tier == "int8" else
                                                      torch.int16).numpy(),
                                      np.asarray(j.X_sorted).view(np.int8 if tier == "int8"
                                                                  else np.int16))


@pytest.mark.parametrize("tier", ["split", "int8"])
def test_sharded_search_matches_jax_and_the_single_device_search(indexes, tier):
    """The 8-way CPU mesh beside the JAX package's 8-device mesh, and the
    port's sharded search against its own single-device one (the lo plane
    cut with the query rows)."""
    j, t = indexes[tier]
    kw = dict(k=10, nprobe=8)
    got = ivf_knn_sharded(None, make_mesh(devices=["cpu"] * 8), index=t, **kw)
    assert_agree(got, jpivf.ivf_knn_sharded(None, jmesh.make_mesh(8), index=j, **kw))
    single = tivf.ivf_knn(None, index=t, **kw)
    assert float((got[1] == single[1]).float().mean()) > 0.999
    np.testing.assert_allclose(got[0].numpy(), single[0].numpy(), atol=1e-4, rtol=0)


def test_estimator_int8_graph(data):
    """UMAP fits on an int8-tier graph (``tests/test_ivf_int8.py``'s
    case: its rows and knobs; 20 of its 60 steps, which the graph does not
    change)."""
    from torchdr_tpu_torch import UMAP, KnnConfig

    rng = np.random.default_rng(3)
    centers = rng.normal(scale=6.0, size=(20, 24)).astype(np.float32)
    X = (centers[rng.integers(0, 20, 2000)] + rng.normal(size=(2000, 24))).astype(np.float32)
    cfg = KnnConfig(mode="ivf", nprobe=8, n_clusters=32, storage="int8")
    with one_torch_thread():
        m = UMAP(n_neighbors=10, max_iter=20, random_state=0, knn_mode=cfg, device="cpu")
        Z = m.fit_transform(X)
    assert Z.shape == (2000, 2) and np.all(np.isfinite(Z))


@pytest.mark.parametrize("crowded", [False, True])
def test_tournament_merge_is_the_slot_by_slot_merge(crowded):
    """``_tournament`` (one top-m, then slot by slot only where a slot holds
    more than t of it) equals the JAX package's merge: each slot's best t,
    then the best m of those; ``crowded`` puts most of the best scores in
    one slot, which the fallback must handle."""
    gen = torch.Generator()
    gen.manual_seed(0)
    g, block, nsl, chunk, t, m = 3, 7, 6, 32, 4, 10
    buf = torch.randn((g, block, nsl * chunk), generator=gen)
    if crowded:
        buf[:, :, :chunk] -= 5.0 * torch.rand((g, block, chunk), generator=gen)
    v1, i1 = torch.topk(buf.reshape(g, block, nsl, chunk), t, dim=3, largest=False)
    want_v, i2 = torch.topk(v1.reshape(g, block, nsl * t), m, dim=2, largest=False)
    want_c = (i2 // t) * chunk + torch.gather(i1.reshape(g, block, nsl * t), 2, i2)
    got_v, got_c = tivf._tournament(buf, chunk, t, m)
    assert torch.equal(got_v, want_v)
    assert torch.equal(torch.gather(buf, 2, got_c), got_v)
    assert torch.equal(torch.sort(got_c, 2).values, torch.sort(want_c, 2).values)
