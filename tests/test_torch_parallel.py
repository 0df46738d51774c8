"""The multi-device path of the PyTorch port (``parallel/``, the row-sharded
row log-sum and the mesh branches of the estimators) against the JAX
package.

The port runs on a single-process mesh of eight CPU devices
(``make_mesh(devices=["cpu"] * 8)``: a device may repeat in a mesh), the
JAX package on its 8-virtual-device mesh (``tests/conftest.py``); the same
numpy inputs, made from a seed, go to both.

Tolerances:

- the mesh arithmetic: exact;
- the plain general K2 and K3 against the interpret-mode TPU kernels: abs
  1e-5 forward and 1e-4 backward, the tolerances of
  ``tests/test_torch_reduce.py`` (the JAX package's own for its kernels);
  against the JAX package's XLA tier evaluated in float64: abs 1e-5 both;
- the sharded row log-sum and its gradient against the JAX package's
  ``pairwise_logkernel_rowlse_sharded``: abs 1e-5, the bound of
  ``tests/test_parallel.py``, also with the JAX side in float64;
- the sharded, ring and cross kNN: distances abs 1e-4 (the JAX package's
  test), indices equal (the data have no ties), and the ring's exact
  recall 1.0;
- the distributed symmetrization: densified, abs 1e-6;
- the UMAP and entropic affinities built over the mesh: equal to the
  port's single-device ones, and within abs 2e-5 densified of the JAX
  package's mesh build, the tolerance of the single-device parity test
  (``tests/test_torch_umap.py::test_umap_affinity_matches_jax``) on its
  data: on far-off clusters the gram form's float32 cancellation moves P by
  ~1e-4 between the packages, with or without a mesh;
- a t-SNE/SNE mesh fit of 10 steps from the JAX package's mesh fit's
  pre-loop state: abs 1e-5 on the embedding, as the single-device loop
  test; a 300-step t-SNE mesh fit on two-moons: silhouette > 0.15 (the JAX
  package's test); a 200-step UMAP mesh fit equal to the port's
  single-device fit (the JAX package's bound between its two fits was
  1e-2; the port's row-sharded step is the one-device step);
- UMAP's row-sharded step against the one-device step at the same state:
  the fire counts equal, the gradient within one float32 spacing of the
  widest row (``test_umap_sharded_step_is_the_one_device_step``), and a
  shard's step with the counter and the edge group as tensors equal to
  its step;
  against ``perfbench/reference/gradient.py`` in float64: widest row gap
  1e-5, float32 arithmetic's (the reference rounds nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.affinity.entropic import EntropicAffinity as JaxEntropicAffinity
from torchdr_tpu.affinity.knn_normalized import UMAPAffinity as JaxUMAPAffinity
from torchdr_tpu.models.neighbor.tsne import SNE as JaxSNE
from torchdr_tpu.models.neighbor.tsne import TSNE as JaxTSNE
from torchdr_tpu.ops import ivf as jivf
from torchdr_tpu.ops.pallas.reduce_kernel import (
    rowlse_bwd_pallas_general,
    rowlse_fwd_pallas_general,
)
from torchdr_tpu.ops.reduce import _rowlse_bwd_general as jax_bwd_general
from torchdr_tpu.ops.reduce import _rowlse_fwd_general as jax_fwd_general
from torchdr_tpu.ops.reduce import pairwise_logkernel_rowlse_sharded as jax_rowlse_sharded
from torchdr_tpu.ops.sparse import sparse_to_dense as jax_sparse_to_dense
from torchdr_tpu.parallel import ivf as jpivf
from torchdr_tpu.parallel import knn as jpknn
from torchdr_tpu.parallel import mesh as jmesh
from torchdr_tpu.parallel.sparse import distributed_symmetrize_sparse as jax_dsym
from torchdr_tpu_torch import SNE, TSNE, UMAP, EntropicAffinity, UMAPAffinity
from torchdr_tpu_torch.eval import silhouette_score
from torchdr_tpu_torch.ops import ivf as tivf
from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
    rowlse_bwd_general,
    rowlse_bwd_general_plain,
    rowlse_fwd_general,
    rowlse_fwd_general_plain,
)
from torchdr_tpu_torch.ops.distance import knn_graph
from torchdr_tpu_torch.ops.reduce import (
    pairwise_logkernel_rowlse,
    pairwise_logkernel_rowlse_sharded,
)
from torchdr_tpu_torch.ops.sparse import sparse_to_dense
from torchdr_tpu_torch.parallel import (
    Mesh,
    ShardedRows,
    chunk_bounds,
    distributed_symmetrize_sparse,
    knn_graph_ring,
    knn_graph_sharded,
    knn_graph_sharded_queries,
    make_mesh,
    pad_to_multiple,
    rank_of_rows,
    replicate,
    shard_rows,
)
from torchdr_tpu_torch.parallel.ivf import ivf_knn_sharded
from torchdr_tpu_torch.utils.interop import load_reference_state


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(8)


def _Z(n, d=2, seed=0, scale=2.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, d))).astype(np.float32)


# --- the mesh and its arithmetic ---


@pytest.mark.parametrize("n", [7, 8, 100, 1037])
@pytest.mark.parametrize("world", [1, 3, 8])
def test_chunk_bounds_cover_everything_as_the_jax_package_does(n, world):
    spans = [chunk_bounds(n, world, r) for r in range(world)]
    assert spans == [jmesh.chunk_bounds(n, world, r) for r in range(world)]
    pos = 0
    for start, size in spans:
        assert start == pos
        pos += size
    assert pos == n and pad_to_multiple(n, world) == jmesh.pad_to_multiple(n, world)


@pytest.mark.parametrize("n, world", [(103, 8), (64, 8), (10, 3), (5, 8)])
def test_rank_of_rows_inverts_the_chunks(n, world):
    want = np.asarray(jmesh.rank_of_rows(jnp.arange(n), n, world))
    np.testing.assert_array_equal(rank_of_rows(np.arange(n), n, world), want)
    np.testing.assert_array_equal(rank_of_rows(torch.arange(n), n, world).numpy(), want)
    for r in range(world):
        start, size = chunk_bounds(n, world, r)
        assert (want[start : start + size] == r).all()


def test_make_mesh_takes_repeated_devices():
    m = make_mesh(devices=["cpu"] * 4)
    assert isinstance(m, Mesh) and len(m) == m.size == 4 and m.axis_names == ("data",)
    assert m.devices == (torch.device("cpu"),) * 4
    assert len(make_mesh(3, axis="rows", devices=["cpu"] * 8)) == 3
    with pytest.raises(ValueError):
        Mesh([])


def test_make_mesh_without_a_card_raises():
    """By default the mesh holds every visible CUDA device; with none it
    raises, as device="auto" does, and a CPU mesh must be asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_shard_rows_and_replicate(mesh):
    X = np.arange(30, dtype=np.float32).reshape(10, 3)
    pieces = shard_rows(X, make_mesh(devices=["cpu"] * 4))
    assert isinstance(pieces, ShardedRows) and pieces.shape == (10, 3)
    assert [p.shape[0] for p in pieces] == [3, 3, 3, 1]
    np.testing.assert_array_equal(torch.cat(list(pieces)).numpy(), X)
    copies = replicate(torch.from_numpy(X), mesh)
    assert len(copies) == 8 and all(c is copies[0] for c in copies)  # one copy per device


# --- the general K2 and K3: plain versions against the JAX package ---

# (n, world, shard): a shard of a 1003-row Z cut as the sharded row log-sum
# cuts it, and the padded last shard of an 8-way cut of 1001 rows
GENERAL_CASES = [(1003, 8, 0), (1003, 8, 3), (1001, 8, 7), (300, 3, 1)]


def _shard(Z, world, r):
    n, d = Z.shape
    chunk = pad_to_multiple(n, world) // world
    Zp = np.zeros((chunk * world, d), np.float32)
    Zp[:n] = Z
    return r * chunk, Zp[r * chunk : (r + 1) * chunk]


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("n, world, r", GENERAL_CASES)
def test_general_forward_matches_the_tpu_kernel_interpret(kernel, n, world, r):
    """At offset 0, offsets past 0 and the padded last shard (n_total below
    the padded length). A row past n_total reads −inf in the port (the JAX
    package's XLA tier); the TPU kernel clamps it at log(1e-30)."""
    Z = _Z(n, seed=n + r)
    off, Zq = _shard(Z, world, r)
    live = max(0, min(Zq.shape[0], n - off))
    want = np.asarray(rowlse_fwd_pallas_general(
        jnp.asarray(Zq), jnp.asarray(Z), off, n, kernel, True, q_tile=64, db_tile=128,
        interpret=True,
    ))
    got = rowlse_fwd_general(torch.from_numpy(Zq), torch.from_numpy(Z), off, n, kernel).numpy()
    np.testing.assert_allclose(got[:live], want[:live], atol=1e-5, rtol=0)
    assert np.isneginf(got[live:]).all()
    np.testing.assert_allclose(want[live:], np.log(np.float32(1e-30)), rtol=1e-6)


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("n, world, r", GENERAL_CASES)
def test_general_backward_matches_the_tpu_kernel_interpret(kernel, n, world, r):
    Z = _Z(n, seed=n + r)
    off, Zq = _shard(Z, world, r)
    live = max(0, min(Zq.shape[0], n - off))
    lse = np.zeros(Zq.shape[0], np.float32)
    lse[:live] = rowlse_fwd_general_plain(torch.from_numpy(Zq), torch.from_numpy(Z), off, n,
                                          kernel).numpy()[:live]
    g = np.random.default_rng(r).random(Zq.shape[0]).astype(np.float32)
    g[live:] = 0.0
    wq, wdb = rowlse_bwd_pallas_general(
        jnp.asarray(Zq), jnp.asarray(Z), off, n, jnp.asarray(lse), jnp.asarray(g), kernel, True,
        q_tile=64, db_tile=128, interpret=True,
    )
    gq, gdb = rowlse_bwd_general(torch.from_numpy(Zq), torch.from_numpy(Z), off, n,
                                 torch.from_numpy(lse), torch.from_numpy(g), kernel)
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gdb.numpy(), np.asarray(wdb), atol=1e-4, rtol=0)
    assert not gq.numpy()[live:].any()


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("n, world, r", [(1003, 8, 0), (1003, 8, 5), (300, 3, 2)])
def test_general_plain_versions_match_the_xla_tier_in_float64(kernel, n, world, r):
    """The JAX package's ``_rowlse_fwd_general`` and ``_rowlse_bwd_general``
    (its database is Z[:n], so n_total = n), evaluated in float64."""
    Z = _Z(n, seed=2 * n + r)
    off, Zq = _shard(Z, world, r)
    live = max(0, min(Zq.shape[0], n - off))
    tq, tZ = torch.from_numpy(Zq), torch.from_numpy(Z)
    got = rowlse_fwd_general_plain(tq, tZ, off, n, kernel).numpy()
    lse = np.where(np.arange(Zq.shape[0]) < live, got, 0.0).astype(np.float32)
    g = np.random.default_rng(r).random(Zq.shape[0]).astype(np.float32) * (
        np.arange(Zq.shape[0]) < live)
    gq, gdb = rowlse_bwd_general_plain(tq, tZ, off, n, torch.from_numpy(lse),
                                       torch.from_numpy(g), kernel)
    with jax.enable_x64(True):
        Zq64, Z64 = jnp.asarray(Zq, jnp.float64), jnp.asarray(Z, jnp.float64)
        want = np.asarray(jax_fwd_general(Zq64, off, Z64, kernel, True, 256))
        wq, wdb = jax_bwd_general(Zq64, off, Z64, jnp.asarray(lse, jnp.float64),
                                  jnp.asarray(g, jnp.float64), kernel, True, 256)
        wq, wdb = np.asarray(wq), np.asarray(wdb)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got[:live], want[:live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(gq.numpy()[:live], wq[:live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(gdb.numpy(), wdb, atol=1e-5, rtol=0)


def test_general_wrappers_check_their_inputs():
    Zq, Z = torch.zeros((4, 2)), torch.zeros((9, 2))
    with pytest.raises(ValueError):
        rowlse_fwd_general(Zq, torch.zeros((9, 3)), 0, 9)
    with pytest.raises(ValueError):
        rowlse_fwd_general(Zq, Z, -1, 9)
    with pytest.raises(ValueError):
        rowlse_bwd_general(Zq, Z, 0, 9, torch.zeros(3), torch.zeros(4))
    with pytest.raises(ValueError, match="kernel"):
        rowlse_fwd_general(Zq, Z, 0, 9, kernel="cauchy")


# --- the row-sharded row log-sum ---


def _sharded_case(kernel, mesh, jax_mesh, x64):
    Z = _Z(1003, seed=11)
    Zt = torch.from_numpy(Z).requires_grad_(True)
    out = pairwise_logkernel_rowlse_sharded(Zt, mesh, kernel, True, 256)
    torch.sin(out).sum().backward()
    dtype = jnp.float64 if x64 else jnp.float32
    Zj = jnp.asarray(Z, dtype)
    want = np.asarray(jax_rowlse_sharded(Zj, jax_mesh, kernel, True, 256))
    want_g = np.asarray(jax.grad(
        lambda z: jnp.sum(jnp.sin(jax_rowlse_sharded(z, jax_mesh, kernel, True, 256))))(Zj))
    assert want.dtype == (np.float64 if x64 else np.float32)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(Zt.grad.numpy(), want_g, atol=1e-5, rtol=0)
    return out.detach(), Zt.grad


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_sharded_rowlse_matches_jax(kernel, mesh, jax_mesh):
    _sharded_case(kernel, mesh, jax_mesh, x64=False)


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_sharded_rowlse_matches_jax_in_float64(kernel, mesh, jax_mesh):
    with jax.enable_x64(True):
        _sharded_case(kernel, mesh, jax_mesh, x64=True)


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("n, world", [(1003, 8), (61, 4), (5, 8), (40, 1)])
def test_sharded_rowlse_equals_the_square_one(kernel, n, world):
    """Any world size, shards past the last row included (n = 5 over 8), and
    bit for bit from one call to the next (the psum in rank order)."""
    mesh = make_mesh(devices=["cpu"] * world)
    Z = _Z(n, seed=n)
    Za = torch.from_numpy(Z).requires_grad_(True)
    Zb = torch.from_numpy(Z).requires_grad_(True)
    sq = pairwise_logkernel_rowlse(Za, kernel)
    sh = pairwise_logkernel_rowlse_sharded(Zb, mesh, kernel)
    torch.sin(sq).sum().backward()
    torch.sin(sh).sum().backward()
    np.testing.assert_allclose(sh.detach().numpy(), sq.detach().numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(Zb.grad.numpy(), Za.grad.numpy(), atol=1e-6, rtol=0)
    Zc = torch.from_numpy(Z).requires_grad_(True)
    torch.sin(pairwise_logkernel_rowlse_sharded(Zc, mesh, kernel)).sum().backward()
    assert torch.equal(Zc.grad, Zb.grad)


# --- kNN over the mesh ---


def test_knn_graph_sharded_matches_jax(mesh, jax_mesh):
    X = np.random.default_rng(0).normal(size=(201, 16)).astype(np.float32)
    wd, wi = jpknn.knn_graph_sharded(jnp.asarray(X), 10, jax_mesh)
    d, i = knn_graph_sharded(torch.from_numpy(X), 10, mesh)
    assert i.dtype == torch.int32 and d.shape == (201, 10)
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    d0, i0 = knn_graph(torch.from_numpy(X), k=10)
    np.testing.assert_array_equal(i.numpy(), i0.numpy())


def test_knn_graph_ring_matches_jax_with_exact_recall(mesh, jax_mesh):
    X = np.random.default_rng(1).normal(size=(163, 16)).astype(np.float32)
    wd, wi = jpknn.knn_graph_ring(jnp.asarray(X), 10, jax_mesh)
    d, i = knn_graph_ring(torch.from_numpy(X), 10, mesh)
    assert i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    _, i0 = knn_graph(torch.from_numpy(X), k=10)
    recall = np.mean([len(set(i[r].tolist()) & set(i0[r].tolist())) / 10 for r in range(163)])
    assert recall == 1.0


def test_knn_graph_ring_holds_one_database_shard_per_device(monkeypatch):
    """At each step a shard's device computes against one visiting database
    shard, never more rows than a chunk."""
    import torchdr_tpu_torch.parallel.knn as pknn

    widths = []
    real = pknn.pairwise_block

    def spy(Xq, Y, metric):
        widths.append(Y.shape[0])
        return real(Xq, Y, metric)

    monkeypatch.setattr(pknn, "pairwise_block", spy)
    X = torch.from_numpy(np.random.default_rng(2).normal(size=(50, 4)).astype(np.float32))
    knn_graph_ring(X, 5, make_mesh(devices=["cpu"] * 4))
    assert len(widths) == 16 and max(widths) == 13


def test_knn_graph_sharded_queries_matches_jax(mesh, jax_mesh):
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(93, 8)).astype(np.float32)
    DB = rng.normal(size=(170, 8)).astype(np.float32)
    wd, wi = jpknn.knn_graph_sharded_queries(jnp.asarray(Q), jnp.asarray(DB), 7, jax_mesh)
    d, i = knn_graph_sharded_queries(torch.from_numpy(Q), torch.from_numpy(DB), 7, mesh)
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


# --- the distributed symmetrization ---


def _sparse(n, k, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    idx[rng.random(idx.shape) < 0.1] = -1  # padding slots
    return rng.random((n, k)).astype(np.float32), idx


@pytest.mark.parametrize("mode", ["sum", "sum_minus_prod"])
@pytest.mark.parametrize("n", [100, 97])
def test_distributed_symmetrize_matches_jax(mode, n, mesh, jax_mesh):
    vals, idx = _sparse(n, 7, seed=n)
    wv, wi = jax_dsym(jnp.asarray(vals), jnp.asarray(idx), jax_mesh, mode=mode)
    v, i = distributed_symmetrize_sparse(torch.from_numpy(vals), torch.from_numpy(idx), mesh,
                                         mode=mode)
    assert v.shape == tuple(wv.shape) and i.dtype == torch.int32
    want = np.asarray(jax_sparse_to_dense(wv, wi, n))
    np.testing.assert_allclose(sparse_to_dense(v, i, n).numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


@pytest.mark.parametrize("mode", ["sum", "sum_minus_prod"])
def test_distributed_symmetrize_keeps_the_strongest_edges_where_k_out_caps(mode, mesh,
                                                                            jax_mesh):
    """k_out = 8 caps rows of up to ~14 merged edges. The port's mesh result
    is its single-device one, which keeps each row's strongest edges as the
    JAX package's single-device ``symmetrize_sparse`` does; the JAX
    package's mesh result keeps others (ROADMAP, "Quirks of the
    reference")."""
    from torchdr_tpu.ops.sparse import symmetrize_sparse as jax_sym
    from torchdr_tpu_torch.ops.sparse import symmetrize_sparse

    n = 100
    vals, idx = _sparse(n, 7, seed=n)
    v, i = distributed_symmetrize_sparse(torch.from_numpy(vals), torch.from_numpy(idx), mesh,
                                         mode=mode, k_out=8)
    v1, i1 = symmetrize_sparse(torch.from_numpy(vals), torch.from_numpy(idx), mode=mode, k_out=8)
    assert torch.equal(v, v1) and torch.equal(i, i1)
    wv, wi = jax_sym(jnp.asarray(vals), jnp.asarray(idx), mode=mode, k_out=8)
    dense = sparse_to_dense(v, i, n).numpy()
    np.testing.assert_allclose(dense, np.asarray(jax_sparse_to_dense(wv, wi, n)), atol=1e-6,
                               rtol=0)
    mv, mi = jax_dsym(jnp.asarray(vals), jnp.asarray(idx), jax_mesh, mode=mode, k_out=8)
    assert np.abs(dense - np.asarray(jax_sparse_to_dense(mv, mi, n))).max() > 1e-2


# --- the affinities and estimators on a mesh ---


@pytest.mark.parametrize("which", ["umap", "entropic"])
def test_affinity_over_the_mesh_matches_jax(which, mesh, jax_mesh):
    # the data of the single-device UMAP affinity parity test: no near-tie
    # at the k-th neighbour, no far-off clusters
    X = np.random.default_rng(10).normal(size=(600, 16)).astype(np.float32)
    if which == "umap":
        wP, wi = JaxUMAPAffinity(n_neighbors=12, mesh=jax_mesh)(X)
        aff = UMAPAffinity(n_neighbors=12, mesh=mesh, device="cpu")
    else:
        wP, wi = JaxEntropicAffinity(perplexity=16, mesh=jax_mesh)(X)
        aff = EntropicAffinity(perplexity=16, mesh=mesh, device="cpu")
    P, i = aff(X)
    P1, i1 = type(aff)(**({"n_neighbors": 12} if which == "umap" else {"perplexity": 16}),
                       device="cpu")(X)
    n = X.shape[0]
    dense = sparse_to_dense(P, i, n).numpy()
    want = np.asarray(jax_sparse_to_dense(wP, wi, n))
    assert np.array_equal(dense > 0, want > 0)  # the same edges
    np.testing.assert_allclose(dense, want, atol=2e-5, rtol=0)
    assert torch.equal(P, P1) and torch.equal(i, i1)
    assert aff._active_mesh() is mesh


def _pre_loop_state(jax_cls, port_cls, kw, mesh, jax_mesh, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(4, 16))
    X = (centers[rng.integers(0, 4, 300)] + rng.normal(size=(300, 16))).astype(np.float32)
    Xj = jnp.asarray(X)
    jm = jax_cls(distributed=True, mesh=jax_mesh, **kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = jax_mesh
    jm.affinity_in._set_fit_mesh(jax_mesh)
    jm._compute_input_affinity(Xj)
    jm.on_affinity_computation_end()
    arrays = {
        "affinity_in": np.asarray(jm.affinity_in_),
        "NN_indices": np.asarray(jm.NN_indices_),
        "init_embedding": np.array(jm._init_embedding(Xj)),
    }
    tm = port_cls(device="cpu", mesh=mesh, **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(None), arrays


@pytest.mark.parametrize("model", ["TSNE", "SNE"])
def test_mesh_fit_short_run_matches_jax(model, mesh, jax_mesh):
    """10 steps of the port's loop on the mesh (the sharded row log-sum every
    step) against the JAX package's mesh loop from the same pre-loop state;
    TSNE's early exaggeration ends after step 3."""
    kw = dict(perplexity=10, max_iter=10, random_state=0)
    if model == "TSNE":
        kw["early_exaggeration_iter"] = 3
    jcls, tcls = (JaxTSNE, TSNE) if model == "TSNE" else (JaxSNE, SNE)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(jcls, tcls, kw, mesh, jax_mesh)
    assert tm._fit_mesh_ is mesh
    Z0 = arrays["init_embedding"]
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), jconsts, {})
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, {})
    assert int(w_it) == g_it == 10
    np.testing.assert_allclose(g_Z.numpy(), np.asarray(w_Z), atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["TSNE", "SNE"])
def test_mesh_fit_gradient_matches_jax_in_float64(model, mesh, jax_mesh):
    """One gradient of the loss on the mesh, the JAX package's evaluated in
    float64 on the same inputs (its sharded row log-sum under x64)."""
    kw = dict(perplexity=10, max_iter=10, random_state=0)
    jcls, tcls = (JaxTSNE, TSNE) if model == "TSNE" else (JaxSNE, SNE)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(jcls, tcls, kw, mesh, jax_mesh)
    Z = np.random.default_rng(1).normal(size=arrays["init_embedding"].shape).astype(np.float32)
    coeff = 12.0 if model == "TSNE" else 1.0
    grad, _ = tm._loss_gradients(torch.from_numpy(Z), tconsts, {}, 0, coeff)
    with jax.enable_x64(True):
        consts64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a, jconsts)
        want = np.asarray(jax.grad(
            lambda z: jm._loss(z, consts64, {}, 0, jax.random.PRNGKey(0), coeff)[0]
        )(jnp.asarray(Z, jnp.float64)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(grad.numpy(), want, atol=1e-5, rtol=0)


def test_tsne_mesh_fit_quality(mesh):
    from sklearn.datasets import make_moons

    X, y = make_moons(n_samples=96, noise=0.05, random_state=0)
    Z = TSNE(perplexity=15, max_iter=300, random_state=0, mesh=mesh,
             device="cpu").fit_transform(X.astype(np.float32))
    assert silhouette_score(Z, y, device="cpu") > 0.15


def test_umap_mesh_fit_matches_the_single_device_fit(mesh):
    from sklearn.datasets import make_moons

    X, _ = make_moons(n_samples=96, noise=0.05, random_state=0)
    X = X.astype(np.float32)
    Z1 = UMAP(n_neighbors=15, max_iter=200, random_state=0, device="cpu").fit_transform(X)
    model = UMAP(n_neighbors=15, max_iter=200, random_state=0, distributed=True, mesh=mesh,
                 device="cpu")
    Z2 = model.fit_transform(X)
    assert model.affinity_in._active_mesh() is mesh
    np.testing.assert_array_equal(Z1, Z2)


def _umap_pre_loop(model, X):
    """(Z0, consts, carry0) of ``model``'s fit of X, the loop left out."""
    state = {}

    def capture(Z0, consts, carry0):
        state.update(Z0=Z0, consts=consts, carry0=carry0)
        return Z0, 0, 0.0

    model._optimize = capture
    model.fit_transform(X)
    return state["Z0"], state["consts"], state["carry0"]


def _umap_rows(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(6, 8))
    return (centers[rng.integers(0, 6, n)] + rng.normal(size=(n, 8))).astype(np.float32)


SCHEDULES = {"groups": dict(edge_schedule="groups", edge_groups=3),
             "exact": dict(edge_schedule="exact"), "bands": dict(edge_schedule="bands")}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_umap_sharded_step_is_the_one_device_step(schedule):
    """On a 4-way CPU mesh the step is row-sharded (``consts["shards"]``);
    at the same Z, consts, carry and negatives it gives the one-device
    step's fire counts exactly and its gradient within one float32 spacing
    of the widest row: no row's sum is split across shards, so only a
    reduction that tiled a shard's rows differently could round a row
    otherwise."""
    mesh4 = make_mesh(devices=["cpu"] * 4)
    model = UMAP(n_neighbors=15, max_iter=100, random_state=0, mesh=mesh4, device="cpu",
                 **SCHEDULES[schedule])
    _, consts, carry = _umap_pre_loop(model, _umap_rows())
    assert [(s["row0"], s["rows"]) for s in consts["shards"]] == [
        chunk_bounds(1200, 4, r) for r in range(4)]
    one = {k: v for k, v in consts.items() if k != "shards"}
    Z = torch.from_numpy(_Z(1200, scale=3.0, seed=2))
    for it in (0, 1, 2, 5, 8, 64):
        neg = torch.from_numpy(np.random.default_rng(it).integers(0, 1200, 512))
        g_mesh, c_mesh = model._gradients(Z, consts, dict(carry), it, 1.0, neg)
        g_one, c_one = model._gradients(Z, one, dict(carry), it, 1.0, neg)
        assert torch.equal(c_mesh["active_edges"], c_one["active_edges"])
        spacing = torch.finfo(torch.float32).eps * float(g_one.abs().amax(1).max())
        torch.testing.assert_close(g_mesh, g_one, atol=spacing, rtol=0)
        # the step counter and the edge group as tensors, as a captured CUDA
        # graph takes them: the same integers in float32, the same bits
        graph_inputs = {"now": torch.tensor(float(it + 1)),
                        "group": torch.tensor([it % consts["edge_groups_G"]])}
        for shard in consts["shards"]:
            want = model._shard_step(Z, neg, shard, it, 1.0)
            got = model._shard_step(Z, neg, dict(shard, **graph_inputs), it, 1.0)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_umap_sharded_step_matches_the_reference_gradient_in_float64():
    """The sharded step at 2,000 rows against the harness's plain float64
    UMAP gradient at the same edges, fire counts and negatives."""
    from perfbench.reference.gradient import umap_step
    from perfbench.watch import widest_row_gap

    model = UMAP(n_neighbors=15, max_iter=100, random_state=0, edge_groups=4,
                 mesh=make_mesh(devices=["cpu"] * 4), device="cpu")
    _, consts, carry = _umap_pre_loop(model, _umap_rows(2000, seed=3))
    assert consts["edge_schedule"] == "groups" and len(consts["shards"]) == 4
    Z = torch.from_numpy(_Z(2000, scale=3.0, seed=4))
    for it in (0, 7):
        neg = torch.from_numpy(np.random.default_rng(it).integers(0, 2000, 512))
        grad, out = model._gradients(Z, consts, dict(carry), it, 1.0, neg)
        want = umap_step(Z, consts["NN"][it % 4], out["active_edges"], neg, model._a, model._b,
                         model.negative_sample_rate)
        assert want.dtype == torch.float64
        assert widest_row_gap(grad, want) < 1e-5


@pytest.mark.parametrize("model_cls", [TSNE, SNE])
def test_mesh_fit_keeps_its_state_on_the_first_device(model_cls, mesh):
    """The deviation from the JAX package's GSPMD row-sharding of the loop
    state: a mesh fit keeps Z, the optimizer's buffers and the affinity on
    the mesh's first device, and only the sharded operations spread over
    the mesh; 5 steps then equal the single-device fit's at 1e-5 (at the
    "auto" lr of 200 rows the first steps blow Z up to ~10, which magnifies
    a summation order's rounding further on)."""
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=6.0, size=(4, 8))
    X = (centers[rng.integers(0, 4, 200)] + rng.normal(size=(200, 8))).astype(np.float32)
    kw = dict(perplexity=10, max_iter=5, random_state=0, device="cpu")
    single = model_cls(**kw).fit_transform(X)
    model = model_cls(mesh=mesh, **kw)
    Z = model.fit_transform(X)
    assert model._fit_mesh_ is mesh and model.device_ == mesh.devices[0]
    assert model.embedding_.device == mesh.devices[0]
    np.testing.assert_allclose(Z, single, atol=1e-5, rtol=0)


def test_mesh_of_one():
    from sklearn.datasets import make_moons

    X, _ = make_moons(n_samples=64, noise=0.05, random_state=0)
    Z = UMAP(n_neighbors=10, max_iter=50, random_state=0, distributed=True,
             mesh=make_mesh(devices=["cpu"]), device="cpu").fit_transform(X.astype(np.float32))
    assert np.isfinite(Z).all()


def test_distributed_auto_resolves_to_no_mesh_on_one_device(monkeypatch):
    model = TSNE(distributed="auto", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert model._resolve_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert model._resolve_mesh() is None
    assert TSNE(device="cpu")._resolve_mesh() is None


def test_estimator_device_and_mesh_must_agree(mesh):
    """With a mesh, device="auto" is the mesh's first device; another
    device raises; a mesh that is not a Mesh raises TypeError."""
    model = TSNE(mesh=mesh)
    assert model._resolve_device() == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        TSNE(mesh=mesh, device="cuda:0")._resolve_device()
    with pytest.raises(TypeError, match="Mesh"):
        TSNE(mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        UMAPAffinity(mesh=[torch.device("cpu")])


# --- the IVF search over the mesh ---


def test_ivf_knn_sharded_matches_jax_and_the_single_device_search(mesh, jax_mesh):
    """One JAX index carried into the port (``index_from_numpy``); the
    sharded searches of both packages, and the port's against its own
    single-device search over the same query blocks."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(16, 16))
    X = np.concatenate([c + rng.normal(size=(128, 16)) for c in centers]).astype(np.float32)
    jindex = jivf.ivf_build(jnp.asarray(X), n_clusters=16)
    tindex = tivf.index_from_numpy(jindex, "cpu")
    wd, wi = jpivf.ivf_knn_sharded(None, jax_mesh, k=8, nprobe=4, index=jindex)
    d, i = ivf_knn_sharded(None, mesh, k=8, nprobe=4, index=tindex)
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    d0, i0 = tivf.ivf_knn(None, k=8, nprobe=4, index=tindex)
    assert float((i == i0).float().mean()) > 0.999
    np.testing.assert_allclose(d.numpy(), d0.numpy(), atol=1e-4, rtol=0)


def test_ivf_affinity_over_the_mesh(mesh):
    from torchdr_tpu_torch.ops.knn_config import KnnConfig

    X = np.random.default_rng(1).normal(size=(512, 8)).astype(np.float32)
    cfg = KnnConfig(mode="ivf", nprobe=4, n_clusters=8)
    P0, i0 = UMAPAffinity(n_neighbors=10, knn_mode=cfg, device="cpu")(X)
    P1, i1 = UMAPAffinity(n_neighbors=10, knn_mode=cfg, mesh=mesh, device="cpu")(X)
    n = X.shape[0]
    np.testing.assert_allclose(sparse_to_dense(P1, i1, n).numpy(),
                               sparse_to_dense(P0, i0, n).numpy(), atol=1e-6, rtol=0)
