"""Ops of the PyTorch port (torchdr_tpu_torch/ops) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port (on the CPU, ``device="cpu"`` tensors).

Tolerances: distances agree to rtol 1e-5 (the port's float32 gram with
norm corrections against the JAX function in float64 and a float64 numpy
reference; the port is within ~2e-7 of both); kNN index sets agree
per row (``torch.topk`` and ``lax.top_k`` may order ties differently);
the calibration agrees to rtol 1e-5 (both bisect the same function, whose
float32 values differ only in summation order), with atol 1e-8 on the
tail of P; the symmetrized graphs
agree densified to atol 1e-6 (the fuzzy union of the same float32 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.affinity.knn_normalized import _umap_calibrate as jax_calibrate
from torchdr_tpu.ops.distance import knn_graph as jax_knn_graph
from torchdr_tpu.ops.metrics import pairwise_block as jax_pairwise_block
from torchdr_tpu.ops.sparse import sparse_to_dense as jax_sparse_to_dense
from torchdr_tpu.ops.sparse import symmetrize_sparse as jax_symmetrize_sparse
from torchdr_tpu_torch.affinity.knn_normalized import _umap_calibrate
from torchdr_tpu_torch.ops.distance import knn_graph
from torchdr_tpu_torch.ops.metrics import pairwise_block
from torchdr_tpu_torch.ops.root_search import binary_search
from torchdr_tpu_torch.ops.sparse import sparse_to_dense, symmetric_degrees, symmetrize_sparse


def _clustered(n, d, seed, n_clusters=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


def _exact_pairwise(X, Y, metric):
    diff = X.astype(np.float64)[:, None, :] - Y.astype(np.float64)[None, :, :]
    if metric == "manhattan":
        return np.abs(diff).sum(-1)
    sq = (diff**2).sum(-1)
    return sq if metric == "sqeuclidean" else np.sqrt(sq)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "manhattan"])
def test_pairwise_block_matches_jax(metric):
    """The port's float32 distances against the JAX function evaluated in
    float64, and against a float64 numpy reference, both at rtol 1e-5.

    A float32 evaluation of the JAX function is no stable reference here:
    in one run of the whole suite (six workers) it came out up to 3.1e-4
    from float64 on 11.8% of the entries, with the port's values within
    1.7e-7 of float64. It did not recur, and the same executables reloaded
    from that run's compilation cache are exact.
    """
    X = _clustered(300, 32, seed=0)
    Y = _clustered(200, 32, seed=1)
    with jax.enable_x64(True):
        want = np.asarray(
            jax_pairwise_block(jnp.asarray(X, jnp.float64), jnp.asarray(Y, jnp.float64), metric)
        )
    got = pairwise_block(torch.from_numpy(X), torch.from_numpy(Y), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, _exact_pairwise(X, Y, metric), rtol=1e-5)


@pytest.mark.parametrize("db_block", [65_536, 256])
def test_knn_graph_exact_matches_jax(db_block):
    """db_block=256 drives the column-chunked running top-k merge."""
    X = np.random.default_rng(2).normal(size=(1500, 32)).astype(np.float32)
    want_d, want_i = jax_knn_graph(jnp.asarray(X), k=15, mode="exact")
    got_d, got_i = knn_graph(torch.from_numpy(X), k=15, mode="exact", db_block=db_block)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5)
    want_i, got_i = np.asarray(want_i), got_i.numpy()
    rows = np.arange(X.shape[0])
    assert not np.any(got_i == rows[:, None])  # self excluded
    for r in rows:
        assert set(got_i[r]) == set(want_i[r])


@pytest.mark.parametrize("db_block", [65_536, 256])
def test_knn_graph_exact_matches_jax_in_float64(db_block):
    """The same comparison with the JAX function evaluated in float64 on the
    same inputs, at the same rtol 1e-5 (see
    ``test_pairwise_block_matches_jax``)."""
    X = np.random.default_rng(2).normal(size=(1500, 32)).astype(np.float32)
    with jax.enable_x64(True):
        want_d, want_i = jax_knn_graph(jnp.asarray(X, jnp.float64), k=15, mode="exact")
        want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    assert want_d.dtype == np.float64
    got_d, got_i = knn_graph(torch.from_numpy(X), k=15, mode="exact", db_block=db_block)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), want_i)  # no near-ties in these data


@pytest.mark.parametrize("db_block", [65_536, 256])
def test_knn_graph_index_dtype_matches_jax(db_block):
    """The indices are int32 in both packages, on both scan paths, and the
    estimators that consume them still widen where torch needs int64."""
    X = _clustered(300, 16, seed=4)
    _, want_i = jax_knn_graph(jnp.asarray(X), k=7, mode="exact")
    _, got_i = knn_graph(torch.from_numpy(X), k=7, mode="exact", db_block=db_block)
    assert np.asarray(want_i).dtype == np.int32
    assert got_i.dtype == torch.int32 and got_i.numpy().dtype == np.asarray(want_i).dtype
    for r in range(X.shape[0]):
        assert set(got_i[r].tolist()) == set(np.asarray(want_i)[r].tolist())


@pytest.mark.parametrize("field, value", [
    ("mode", "bogus"), ("precision", "fp8"), ("merge", "heap"), ("nomination", "random"),
    ("storage", "int4"), ("storage", "bf16"),
])
def test_knn_config_refuses_what_jax_refuses(field, value):
    from torchdr_tpu.ops import KnnConfig as JaxKnnConfig
    from torchdr_tpu_torch import KnnConfig

    with pytest.raises(ValueError) as want:
        JaxKnnConfig(**{field: value})
    with pytest.raises(ValueError) as got:
        KnnConfig(**{field: value})
    assert str(got.value) == str(want.value).replace("TorchDR-TPU", "TorchDR-Torch")


@pytest.mark.parametrize("field, values", [
    ("mode", ("exact", "approx", "ivf")),
    ("precision", ("highest", "high", "default")),
    ("merge", (None, "approx", "exact", "tournament")),
    ("nomination", (None, "flat", "adjacency", "supers")),
    ("storage", ("auto", "f32", "split", "int8")),
])
def test_knn_config_accepts_what_jax_accepts(field, values):
    from torchdr_tpu.ops import KnnConfig as JaxKnnConfig
    from torchdr_tpu_torch import KnnConfig

    for value in values:
        want = JaxKnnConfig(**{field: value})
        got = KnnConfig(**{field: value})
        assert got.kwargs() == want.kwargs()


@pytest.mark.parametrize("preset", ["EXACT", "FAST", "IVF"])
def test_knn_config_presets_match_jax(preset):
    import dataclasses

    import torchdr_tpu.ops as jax_ops
    import torchdr_tpu_torch
    import torchdr_tpu_torch.ops as ops

    want = getattr(jax_ops, preset)
    got = getattr(torchdr_tpu_torch, preset)
    assert got is getattr(ops, preset)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.kwargs() == want.kwargs()
    assert sorted(got.kwargs()) == ["block_size", "mode", "precision", "recall_target"]


def test_knn_config_fields_match_jax():
    import dataclasses

    from torchdr_tpu.ops import KnnConfig as JaxKnnConfig
    from torchdr_tpu_torch import KnnConfig

    want = [(f.name, f.default) for f in dataclasses.fields(JaxKnnConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(KnnConfig)] == want


def test_knn_graph_approx_maps_to_exact():
    X = _clustered(400, 16, seed=3)
    Xt = torch.from_numpy(X)
    d_exact, i_exact = knn_graph(Xt, k=10, mode="exact")
    d_approx, i_approx = knn_graph(Xt, k=10, mode="approx")
    assert torch.equal(d_exact, d_approx) and torch.equal(i_exact, i_approx)


def test_umap_calibrate_matches_jax():
    X = _clustered(1200, 32, seed=4)
    X = X - X.mean(0, keepdims=True)
    C, _ = jax_knn_graph(jnp.asarray(X), k=15)
    C = np.array(C)
    want = [np.asarray(a) for a in jax_calibrate(jnp.asarray(C), 15.0, 100)]
    got = [a.numpy() for a in _umap_calibrate(torch.from_numpy(C), 15.0, 100)]
    for name, g, w in zip(("P", "rho", "eps"), got, want):
        # P = exp(-x/eps) carries eps's relative error times x/eps, which
        # reaches ~20 in a row's tail: tail values (P < 1e-3) agree to 1e-8
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-8 if name == "P" else 0, err_msg=name)


def test_binary_search_sync_interval_is_bit_identical():
    """Testing the stop condition every few iterations changes nothing:
    converged rows are frozen by the active mask."""
    rng = np.random.default_rng(5)
    target = torch.from_numpy(rng.uniform(0.01, 50.0, 257).astype(np.float32))

    def f(x):
        return torch.log(x) - torch.log(target)

    every = binary_search(f, 257, sync_every=1, device="cpu")
    sparse = binary_search(f, 257, sync_every=8, device="cpu")
    assert torch.equal(every, sparse)
    np.testing.assert_allclose(every.numpy(), target.numpy(), rtol=1e-5)


def _knn_values(n, k, seed):
    X = _clustered(n, 8, seed=seed)
    C, idx = jax_knn_graph(jnp.asarray(X), k=k)
    P, _, _ = jax_calibrate(C, float(k), 100)
    P, idx = np.asarray(P), np.asarray(idx).astype(np.int32)
    # a few padding slots, as a pruned or capped graph carries
    rng = np.random.default_rng(seed)
    pad = rng.random(P.shape) < 0.05
    return np.where(pad, 0.0, P).astype(np.float32), np.where(pad, -1, idx)


@pytest.mark.parametrize("mode", ["sum_minus_prod", "sum"])
@pytest.mark.parametrize("capped", [False, True])
def test_symmetrize_sparse_matches_jax(mode, capped):
    P, idx = _knn_values(500, 10, seed=6)
    max_deg = int(symmetric_degrees(torch.from_numpy(idx)).max())
    k_out = 8 if capped else None
    if capped:
        assert k_out < max_deg  # forces value-priority packing
    wv, wi = jax_symmetrize_sparse(jnp.asarray(P), jnp.asarray(idx), mode=mode, k_out=k_out)
    gv, gi = symmetrize_sparse(torch.from_numpy(P), torch.from_numpy(idx), mode=mode, k_out=k_out)
    assert tuple(gv.shape) == tuple(wv.shape)
    want = np.asarray(jax_sparse_to_dense(wv, wi, P.shape[0]))
    got = sparse_to_dense(gv, gi, P.shape[0]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_symmetric_degrees_matches_definition():
    _, idx = _knn_values(300, 6, seed=7)
    valid = idx >= 0
    want = valid.sum(1) + np.bincount(idx[valid], minlength=300)
    np.testing.assert_array_equal(symmetric_degrees(torch.from_numpy(idx)).numpy(), want)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "manhattan", "angular"])
def test_indexed_block_matches_jax(metric):
    from torchdr_tpu.ops.metrics import indexed_block as jax_indexed_block
    from torchdr_tpu_torch.ops.metrics import indexed_block

    rng = np.random.default_rng(8)
    Xq = rng.normal(size=(100, 8)).astype(np.float32)
    Yk = rng.normal(size=(100, 7, 8)).astype(np.float32)
    want = np.asarray(jax_indexed_block(jnp.asarray(Xq), jnp.asarray(Yk), metric))
    got = indexed_block(torch.from_numpy(Xq), torch.from_numpy(Yk), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pairwise_distances_topk_matches_jax():
    from torchdr_tpu.ops.distance import pairwise_distances as jax_pairwise_distances
    from torchdr_tpu_torch.ops.distance import pairwise_distances

    X = np.random.default_rng(9).normal(size=(200, 12)).astype(np.float32)
    wd, wi = jax_pairwise_distances(jnp.asarray(X), k=5, exclude_diag=True)
    gd, gi = pairwise_distances(torch.from_numpy(X), k=5, exclude_diag=True)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_pairwise_distances_topk_matches_jax_in_float64():
    """As above with the JAX function evaluated in float64, at the same
    rtol 1e-5."""
    from torchdr_tpu.ops.distance import pairwise_distances as jax_pairwise_distances
    from torchdr_tpu_torch.ops.distance import pairwise_distances

    X = np.random.default_rng(9).normal(size=(200, 12)).astype(np.float32)
    with jax.enable_x64(True):
        wd, wi = jax_pairwise_distances(jnp.asarray(X, jnp.float64), k=5, exclude_diag=True)
        wd, wi = np.asarray(wd), np.asarray(wi)
    assert wd.dtype == np.float64
    gd, gi = pairwise_distances(torch.from_numpy(X), k=5, exclude_diag=True)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize("dim", [0, 1])
def test_kmin_kmax_match_jax(dim):
    from torchdr_tpu.ops.reductions import kmax as jax_kmax
    from torchdr_tpu.ops.reductions import kmin as jax_kmin
    from torchdr_tpu_torch.ops.reductions import kmax, kmin

    C = np.random.default_rng(10).normal(size=(40, 30)).astype(np.float32)
    for port, ref in ((kmin, jax_kmin), (kmax, jax_kmax)):
        gv, gi = port(torch.from_numpy(C), 4, dim=dim)
        wv, wi = ref(jnp.asarray(C), 4, dim=dim)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("u_based", [True, False])
def test_svd_flip_matches_jax(u_based):
    from torchdr_tpu.ops.reductions import svd_flip as jax_svd_flip
    from torchdr_tpu_torch.ops.reductions import svd_flip

    rng = np.random.default_rng(11)
    u = rng.normal(size=(20, 5)).astype(np.float32)
    v = rng.normal(size=(5, 9)).astype(np.float32)
    wu, wv = jax_svd_flip(jnp.asarray(u), jnp.asarray(v), u_based_decision=u_based)
    gu, gv = svd_flip(torch.from_numpy(u), torch.from_numpy(v), u_based_decision=u_based)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_topk_index_dtypes_match_jax():
    """``pairwise_distances(k=...)``, ``kmin`` and ``kmax`` return int32
    indices, as ``lax.top_k`` does in the JAX package."""
    from torchdr_tpu.ops.distance import pairwise_distances as jax_pairwise_distances
    from torchdr_tpu.ops.reductions import kmax as jax_kmax
    from torchdr_tpu.ops.reductions import kmin as jax_kmin
    from torchdr_tpu_torch.ops.distance import pairwise_distances
    from torchdr_tpu_torch.ops.reductions import kmax, kmin

    X = np.random.default_rng(11).normal(size=(50, 6)).astype(np.float32)
    pairs = [
        (pairwise_distances(torch.from_numpy(X), k=4, exclude_diag=True)[1],
         jax_pairwise_distances(jnp.asarray(X), k=4, exclude_diag=True)[1]),
        (kmin(torch.from_numpy(X), 3, dim=0)[1], jax_kmin(jnp.asarray(X), 3, dim=0)[1]),
        (kmax(torch.from_numpy(X), 3, dim=1)[1], jax_kmax(jnp.asarray(X), 3, dim=1)[1]),
    ]
    for got, want in pairs:
        assert np.asarray(want).dtype == np.int32
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n, query_chunk, cross", [
    (900, 256, False), (900, 300, False), (500, 128, True), (700, 1000, False),
])
def test_knn_graph_host_chunked_is_knn_graph(n, query_chunk, cross):
    """Bit for bit the port's ``knn_graph``: the same products row by row,
    and each row's own id moved out by a stable reorder of k + 1."""
    from torchdr_tpu_torch.ops.distance import knn_graph_host_chunked

    rng = np.random.default_rng(n)
    X = torch.from_numpy(rng.normal(size=(n, 12)).astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(300, 12)).astype(np.float32)) if cross else None
    kw = dict(exclude_diag=False) if cross else {}
    d1, i1 = knn_graph(X, Y, k=7, **kw)
    d2, i2 = knn_graph_host_chunked(X, Y, k=7, query_chunk=query_chunk)
    assert i2.dtype == torch.int32
    assert torch.equal(d1, d2) and torch.equal(i1, i2)


def test_knn_graph_host_chunked_matches_jax():
    """The JAX package's own cases (``tests/test_ops.py``, host-chunked
    exact kNN), index for index."""
    from torchdr_tpu.ops.distance import knn_graph_host_chunked as jax_chunked
    from torchdr_tpu_torch.ops.distance import knn_graph_host_chunked

    X = np.array(jax.random.normal(jax.random.PRNGKey(0), (900, 12)))
    want = jax_chunked(jnp.asarray(X), k=7, query_chunk=256)
    got = knn_graph_host_chunked(torch.from_numpy(X), k=7, query_chunk=256)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    Xc = np.array(jax.random.normal(jax.random.PRNGKey(1), (500, 8)))
    Yc = np.array(jax.random.normal(jax.random.PRNGKey(2), (300, 8)))
    want = jax_chunked(jnp.asarray(Xc), jnp.asarray(Yc), k=5, query_chunk=128)
    got = knn_graph_host_chunked(torch.from_numpy(Xc), torch.from_numpy(Yc), k=5, query_chunk=128)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
