"""Tests of the PyTorch port that need an NVIDIA card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card. This file
imports neither JAX nor the JAX package, so on the machine with the card
it runs without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torchdr_tpu_torch import SNE, TSNE, UMAP
from torchdr_tpu_torch.ops.attraction import knn_attraction_loss, knn_transpose
from torchdr_tpu_torch.ops.cuda.attraction_kernel import tsne_attraction, tsne_attraction_plain
from torchdr_tpu_torch.ops.cuda.gather_kernel import (
    bucket_2level,
    bucket_2level_plain,
    bucket_onehot,
    bucket_onehot_plain,
    bucket_take,
    bucket_take_plain,
)
from torchdr_tpu_torch.ops.cuda import reduce_kernel
from torchdr_tpu_torch.ops.cuda.build import sm_count
from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
    k2_general_grid,
    rows_per_block,
    rowlse_bwd,
    rowlse_bwd_general,
    rowlse_bwd_general_plain,
    rowlse_bwd_plain,
    rowlse_fwd,
    rowlse_fwd_general,
    rowlse_fwd_general_plain,
    rowlse_fwd_plain,
    square_grid,
)
from torchdr_tpu_torch.ops.reduce import (
    pairwise_logkernel_rowlse,
    pairwise_logkernel_rowlse_sharded,
)
from torchdr_tpu_torch.parallel import chunk_bounds, make_mesh
from torchdr_tpu_torch.ops.cuda.umap_kernel import (
    fused_shared_repulsion,
    repulsion_grid,
    rows_per_tile,
    shared_repulsion_plain,
)

A, B, EPS = 1.577, 0.8951, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _hold_k1(Z, neg, w, eps=EPS):
    """K1 against a float64 evaluation of its function (the plain version on
    double tensors) and against the plain version: within 1e-4 of float64
    (the JAX package's tolerance for its kernel), within 3x the plain
    version's own distance from float64 (floor 2e-6), and within 2e-5 of the
    plain version (both round a near-collision's term of up to 28 four or
    five times in float32, at different places; ``chip_smoke.py`` derives
    it)."""
    before = fused_shared_repulsion.launches
    got = fused_shared_repulsion(Z, neg, w, A, B, eps)
    assert fused_shared_repulsion.launches == before + 1
    plain = shared_repulsion_plain(Z, neg, w, A, B, eps)
    ref = shared_repulsion_plain(Z.double(), neg, w.double(), A, B, eps)
    assert got.shape == Z.shape and torch.isfinite(got).all()
    plain_64 = float((plain.double() - ref).abs().max())
    assert float((got.double() - ref).abs().max()) <= min(1e-4, 3.0 * max(plain_64, 2e-6))
    assert float((got - plain).abs().max()) <= 2e-5


def _k1_inputs(cuda, n, S, d, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    Z = torch.from_numpy((scale * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    neg = torch.from_numpy(rng.integers(0, n, S)).to(cuda)
    w = torch.from_numpy((rng.integers(0, 40, n) / S).astype(np.float32)).to(cuda)
    return Z, neg, w


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 7, 512, 2048, 2051])
@pytest.mark.parametrize("n", ["1", "2", "tile-1", "tile", "tile+1", "5003"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k1_kernel_matches_plain(cuda, d, n, S):
    """The ragged edges of the grid: a block of threads that walk the whole
    sample owns ``rows_per_tile(d, 1)`` rows, and with the sample split over
    32 lanes an eighth of a warp's; n one under, at and one over the former,
    the smallest n, and a ragged n of many tiles. S of one negative, less
    than a step, whole steps, and a ragged last step."""
    tile = rows_per_tile(d, 1)
    n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(n) or int(n)
    _hold_k1(*_k1_inputs(cuda, n, S, d, seed=n + d + S))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "own_rows", "duplicate_ids", "duplicate_rows", "near_collision", "scale_1e3",
    "scale_1e-3_clips", "int32_ids", "eps_0", "staged_in_tiles", "staged_in_tiles_eps_0",
])
def test_k1_special_inputs(cuda, case):
    n, S, eps = 5003, 512, EPS
    if case.startswith("staged_in_tiles"):
        S = 6000  # more than a block stages at once
    Z, neg, w = _k1_inputs(cuda, n, S, 2, seed=7)
    if case == "own_rows":  # every negative is one of the first S rows
        neg = torch.arange(S, device=cuda)
    elif case == "duplicate_ids":
        neg[1::2] = neg[::2]
    elif case == "duplicate_rows":  # D = 0 between different rows
        Z[n // 2:] = Z[: n - n // 2].clone()
    elif case == "near_collision":  # two rows 1e-4 apart, one of them sampled
        Z[1] = Z[0] + 1e-4
        neg[0] = 0
    elif case == "scale_1e3":  # D ~ 1e7: every term tiny
        Z = Z * 1e3
    elif case == "scale_1e-3_clips":  # D << eps: |coef| ~ 2b/eps, every row clips
        Z, w = Z * 1e-3 / 3.0, w + 1e4
    elif case == "int32_ids":
        neg = neg.int()
    elif case.endswith("eps_0"):  # the instantiation that tests the ids
        neg[:256] = torch.arange(256, device=cuda)
        eps = 0.0
    _hold_k1(Z.contiguous(), neg, w, eps)
    if case == "scale_1e-3_clips":
        assert float(fused_shared_repulsion(Z, neg, w, A, B).abs().min()) == 4.0


@pytest.mark.cuda
def test_k1_empty_sample_and_no_rows(cuda):
    Z, _, w = _k1_inputs(cuda, 300, 4, 2, seed=3)
    none = torch.empty((0,), dtype=torch.int64, device=cuda)
    assert float(fused_shared_repulsion(Z, none, w, A, B).abs().max()) == 0.0
    before = fused_shared_repulsion.launches
    out = fused_shared_repulsion(Z[:0], none, w[:0], A, B)
    assert out.shape == (0, 2) and fused_shared_repulsion.launches == before


@pytest.mark.cuda
def test_k1_rejects_wide_embeddings_on_the_card(cuda):
    Z = torch.zeros((16, 9), device=cuda)
    with pytest.raises(ValueError, match="d <= 8"):
        fused_shared_repulsion(Z, torch.arange(4, device=cuda), torch.ones(16, device=cuda), A, B)


@pytest.mark.cuda
@pytest.mark.parametrize("n, S, d, eps", [
    (5003, 512, 2, EPS), (5003, 512, 3, EPS), (5003, 512, 8, EPS), (3000, 2048, 2, EPS),
    (5003, 6000, 2, 0.0), (1_300_000, 512, 2, EPS),
], ids=["5003-512-2", "5003-512-3", "5003-512-8", "lanes", "tiles-eps0", "1.3M"])
def test_k1_row_ranges_side_by_side_are_one_launch(cuda, n, S, d, eps):
    """K1 over rows [row0, row0 + rows): the range (0, n) is the default
    launch, and the four shards' ranges of a mesh, side by side, give its
    bits. "lanes": at 3,000 rows a row's negatives are split over several
    lanes, which the wrapper takes from Z's n for every range."""
    Z, neg, w = _k1_inputs(cuda, n, S, d, seed=n + S + d)
    if n < 10_000:
        _hold_k1(Z, neg, w, eps)
    if n == 3000:
        assert repulsion_grid(n, S, d, sm_count(Z.device.index))[0] > 1
    whole = fused_shared_repulsion(Z, neg, w, A, B, eps)
    before = fused_shared_repulsion.launches
    assert torch.equal(fused_shared_repulsion(Z, neg, w, A, B, eps, row0=0, rows=n), whole)
    parts = [fused_shared_repulsion(Z, neg, w[r0 : r0 + rows], A, B, eps, row0=r0, rows=rows)
             for r0, rows in (chunk_bounds(n, 4, r) for r in range(4))]
    assert fused_shared_repulsion.launches == before + 5
    assert [p.shape[0] for p in parts] == [chunk_bounds(n, 4, r)[1] for r in range(4)]
    assert torch.equal(torch.cat(parts), whole)
    with pytest.raises(ValueError, match="do not lie"):
        fused_shared_repulsion(Z, neg, w[:10], A, B, row0=n - 5, rows=10)


def _umap_pre_loop(model, X):
    """(consts, carry0) of ``model``'s fit of X, the loop left out."""
    state = {}

    def capture(Z0, consts, carry0):
        state.update(consts=consts, carry0=carry0)
        return Z0, 0, 0.0

    model._optimize = capture
    model.fit_transform(X)
    return state["consts"], state["carry0"]


def _sharded_step_against_one_card(mesh, schedule, n=20_000, its=(0, 1, 2, 5, 8, 64, 1, 2, 64)):
    """The row-sharded UMAP step over ``mesh`` and the one-card step at the
    same Z, consts, carry and negatives: the gradient and the fire counts
    equal bit for bit, the shards run eagerly and replayed from CUDA graphs
    (the first step eager, a variant's first step captured, its later steps
    replayed), with K1 launched once a shard a step."""
    rng = np.random.default_rng(5)
    centers = rng.normal(scale=6.0, size=(8, 16))
    X = (centers[rng.integers(0, 8, n)] + rng.normal(size=(n, 16))).astype(np.float32)
    kw = {"groups": dict(edge_schedule="groups", edge_groups=4),
          "exact": dict(edge_schedule="exact"), "bands": dict(edge_schedule="bands")}[schedule]
    model = UMAP(n_neighbors=15, max_iter=100, random_state=0, mesh=mesh, **kw)
    consts, carry = _umap_pre_loop(model, X)
    assert [s["device"] for s in consts["shards"]] == list(mesh.devices)
    assert "graphs" in consts
    one = {k: v for k, v in consts.items() if k not in ("shards", "graphs")}
    eager = {k: v for k, v in consts.items() if k != "graphs"}
    first = mesh.devices[0]
    Z = torch.from_numpy((3.0 * rng.normal(size=(n, 2))).astype(np.float32)).to(first)
    for it in its:
        neg = torch.from_numpy(rng.integers(0, n, 512)).to(first)
        g_one, c_one = model._gradients(Z, one, dict(carry), it, 1.0, neg)
        for way in (eager, consts):
            before = fused_shared_repulsion.launches
            g, c = model._gradients(Z, way, dict(carry), it, 1.0, neg)
            assert fused_shared_repulsion.launches == before + len(mesh)
            assert g.device == c["active_edges"].device == first
            assert torch.equal(c["active_edges"], c_one["active_edges"]), (it, way is consts)
            assert torch.equal(g, g_one), (it, way is consts)
        Z = Z - 0.5 * g_one  # the next step at another state
    assert consts["graphs"].graphs  # the replays ran


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["groups", "exact", "bands"])
def test_umap_sharded_step_on_one_card_is_the_one_card_step(cuda, schedule):
    _sharded_step_against_one_card(make_mesh(devices=["cuda:0"] * 4), schedule)


@pytest.mark.cuda
def test_umap_sharded_step_across_cards_is_the_one_card_step(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards: the step across distinct cards")
    _sharded_step_against_one_card(make_mesh(), "groups")


@pytest.mark.cuda
def test_umap_fit_across_cards(cuda):
    """``UMAP(distributed=True)`` over every card, on the IVF: K1 once a
    shard a step, and the mesh's spans in ``timings_``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards: a fit across distinct cards")
    from torchdr_tpu_torch import IVF

    rng = np.random.default_rng(6)
    centers = rng.normal(scale=8.0, size=(8, 16))
    X = (centers[rng.integers(0, 8, 30_000)] + rng.normal(size=(30_000, 16))).astype(np.float32)
    fused_shared_repulsion.launches = 0
    model = UMAP(n_neighbors=15, max_iter=100, random_state=0, knn_mode=IVF, distributed=True)
    Z = model.fit_transform(X)
    world = torch.cuda.device_count()
    assert fused_shared_repulsion.launches == world * model.n_iter_
    assert {"knn.build", "knn.replicate", "knn.shards", "affinity.exchange"} <= set(model.timings_)
    assert Z.shape == (30_000, 2) and np.all(np.isfinite(Z))


@pytest.mark.cuda
def test_fit_on_the_card_launches_k1_every_step(cuda):
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(4, 16))
    X = (centers[rng.integers(0, 4, 2000)] + rng.normal(size=(2000, 16))).astype(np.float32)
    fused_shared_repulsion.launches = 0
    model = UMAP(n_neighbors=15, max_iter=100, random_state=0)
    Z = model.fit_transform(X)
    assert fused_shared_repulsion.launches == model.n_iter_ == 100
    assert Z.shape == (2000, 2) and np.all(np.isfinite(Z))


def _symmetric_counts():
    return rowlse_fwd.symmetric_launches, rowlse_bwd.symmetric_launches


def _hold_k2_k3_to_plain(Z, kernel):
    """K2 (the diagonal excluded and kept) and K3 against their plain
    versions. K2: 1e-5 of max(1, |lse|) (float32 tile sums, an approximate
    reciprocal or exp2 of 1-2 ulp, against one float64 sum of float32
    terms); K3: 1e-4 of max |dZ| (the same products, fused and summed in
    float32 tiles then float64, against float64)."""
    before = (rowlse_fwd.launches, rowlse_bwd.launches)
    for exclude_diag in (False, True):
        lse = rowlse_fwd(Z, kernel, exclude_diag)
        want = rowlse_fwd_plain(Z, kernel, exclude_diag)
        if Z.shape[0] == 1 and exclude_diag:  # a row with no term: -inf in both
            assert torch.isneginf(lse).all() and torch.isneginf(want).all()
        else:
            assert torch.isfinite(lse).all()
            assert float((lse - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    if Z.shape[0] == 1:  # ... and a zero gradient, though exp(-lse) is infinite
        assert float(rowlse_bwd(Z, want, torch.ones_like(want), kernel).abs().max()) == 0.0
        return
    g = torch.softmax(want, 0)
    got = rowlse_bwd(Z, want, g, kernel)
    ref = rowlse_bwd_plain(Z, want, g, kernel)
    assert (rowlse_fwd.launches, rowlse_bwd.launches) == (before[0] + 2, before[1] + 1)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("n", ["1", "2", "tile-1", "tile", "tile+1", "5003"])
def test_k2_k3_kernels_match_plain(cuda, kernel, n, d):
    """The ragged edges of the tiling: a block owns ``rows_per_block(d)``
    rows (a register tile of 4 or 2 rows per thread), so n one under, at and
    one over it, the smallest n, and a ragged n of several row tiles."""
    tile = rows_per_block(d)
    n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(n) or int(n)
    rng = np.random.default_rng(n + d)
    Z = torch.from_numpy((3.0 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    _hold_k2_k3_to_plain(Z, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("d", [2, 3, 8])
def test_k2_k3_rows_straddle_diagonal_tiles(cuda, kernel, d):
    """n of a little over two row tiles: the column chunks and their
    256-column tiles start and end inside the row tiles, so every row tile
    meets masked and unmasked tiles, and the last one is ragged."""
    n = 2 * rows_per_block(d) + 300
    rng = np.random.default_rng(d)
    Z = torch.from_numpy((2.0 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    _hold_k2_k3_to_plain(Z, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_k2_k3_duplicate_rows(cuda, kernel):
    """Duplicate rows: d² = 0 off the diagonal, where only the index, not
    the distance, tells the diagonal term from a neighbour's."""
    rng = np.random.default_rng(11)
    base = (2.0 * rng.normal(size=(700, 2))).astype(np.float32)
    Z = torch.from_numpy(np.concatenate([base, base[:400], base[:50]])).to(cuda)
    _hold_k2_k3_to_plain(Z, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("reduction", ["logsumexp", "mean"])
def test_rowlse_gradient_on_the_card_matches_plain(cuda, kernel, reduction):
    """``pairwise_logkernel_rowlse`` through ``torch.autograd.grad``: K2 and
    K3 on the card against the plain versions, which the same Function takes
    for a CPU tensor. 1e-4 of the largest entry, K3's tolerance."""
    rng = np.random.default_rng(12)
    Z = (2.0 * rng.normal(size=(3001, 2))).astype(np.float32)

    def grad(Zt):
        Zt = Zt.requires_grad_(True)
        rows = pairwise_logkernel_rowlse(Zt, kernel)
        loss = torch.logsumexp(rows, 0) if reduction == "logsumexp" else rows.mean()
        return torch.autograd.grad(loss, Zt)[0]

    before = (rowlse_fwd.launches, rowlse_bwd.launches, *_symmetric_counts())
    got = grad(torch.from_numpy(Z).to(cuda)).cpu()
    walk = int(kernel == "student")  # the student mode's gradient on the symmetric walk
    assert (rowlse_fwd.launches, rowlse_bwd.launches, *_symmetric_counts()) == (
        before[0] + 1, before[1] + 1, before[2] + walk, before[3] + walk)
    want = grad(torch.from_numpy(Z))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_k2_keeps_underflowing_gaussian_rows_exact(cuda):
    g = (torch.arange(20, dtype=torch.float32) * 11.0).to(cuda)
    Z = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2).contiguous()
    lse = rowlse_fwd(Z, "gaussian")
    assert torch.isfinite(lse).all() and float(lse.max()) < -100
    assert float((lse - rowlse_fwd_plain(Z, "gaussian")).abs().max()) <= 1e-5 * float(lse.abs().max())


@pytest.mark.cuda
def test_tsne_fit_on_the_card_launches_k2_k3_every_step(cuda):
    rng = np.random.default_rng(1)
    centers = rng.normal(scale=8.0, size=(4, 16))
    X = (centers[rng.integers(0, 4, 1500)] + rng.normal(size=(1500, 16))).astype(np.float32)
    rowlse_fwd.launches = rowlse_bwd.launches = tsne_attraction.launches = 0
    rowlse_fwd.symmetric_launches = rowlse_bwd.symmetric_launches = 0
    model = TSNE(perplexity=20, max_iter=120, random_state=0)
    Z = model.fit_transform(X)
    assert rowlse_fwd.launches == rowlse_bwd.launches == model.n_iter_ == 120
    # the student mode's symmetric walk, every step
    assert rowlse_fwd.symmetric_launches == rowlse_bwd.symmetric_launches == 120
    assert tsne_attraction.launches == 120  # A1, the attraction, once a step
    assert Z.shape == (1500, 2) and np.all(np.isfinite(Z))


def _a1_graph(cuda, n, k, d, seed, scale=3.0, mutual=False):
    """Z (n, d), NN (n, k) int32 with about a tenth pads (P = 0 there), P
    row-normalised. Ids drawn with repeats, and a hub (row 0 in the first
    column of half the rows); or, with ``mutual``, row i's ids i ± k/2
    distinct offsets, so that most edges are mutual pairs."""
    rng = np.random.default_rng(seed)
    Z = (scale * rng.normal(size=(n, d))).astype(np.float32)
    if mutual:
        half = rng.choice(np.arange(1, (n + 1) // 2), (k + 1) // 2, replace=False)
        offsets = np.concatenate([half, n - half])[:k]
        NN = (np.arange(n)[:, None] + offsets[None, :]) % n
    else:
        NN = rng.integers(0, n, size=(n, k))
        NN[: (n + 1) // 2, 0] = 0
    NN[rng.random((n, k)) < 0.1] = -1
    P = np.where(NN >= 0, rng.random((n, k)), 0.0)
    P = (P / np.maximum(P.sum(1, keepdims=True), 1e-12)).astype(np.float32)
    return (torch.from_numpy(Z).to(cuda), torch.from_numpy(NN.astype(np.int32)).to(cuda),
            torch.from_numpy(P).to(cuda))


def _hold_a1(Z, NN, P, kernel):
    """A1 against a float64 evaluation of its function (the plain version on
    double tensors) and against the plain version in float32, at K1's
    tolerances relative to the largest entry where it passes 1: within 1e-4
    of float64, within 3x the plain version's own distance from it (floor
    2e-6), and within 2e-5 of the plain version; the gradient and the rows'
    losses alike."""
    transpose = knn_transpose(NN, P)
    before = tsne_attraction.launches
    got = tsne_attraction(Z, NN, P, transpose, kernel)
    assert tsne_attraction.launches == before + 1
    plain = tsne_attraction_plain(Z, NN, P, transpose, kernel)
    transpose_64 = tuple(t.double() if t.is_floating_point() else t for t in transpose)
    ref = tsne_attraction_plain(Z.double(), NN, P.double(), transpose_64, kernel)
    for g, p, r in zip(got, plain, ref):
        assert g.shape == r.shape and g.dtype == torch.float32 and torch.isfinite(g).all()
        scale = max(1.0, float(r.abs().max()))
        plain_64 = float((p.double() - r).abs().max()) / scale
        assert float((g.double() - r).abs().max()) / scale <= min(1e-4, 3.0 * max(plain_64, 2e-6))
        assert float((g - p).abs().max()) / scale <= 2e-5
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [1, 90])
@pytest.mark.parametrize("n", [1, 33, 1_000, 70_000])
def test_a1_matches_plain(cuda, n, k, d, kernel):
    _hold_a1(*_a1_graph(cuda, n, k, d, seed=n + k + d), kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1_000, 70_000])
def test_a1_matches_plain_on_mutual_pairs(cuda, n, d, kernel):
    """Most edges mutual: a row meets each such neighbour among its
    out-edges and again among its in-edges."""
    _hold_a1(*_a1_graph(cuda, n, 90, d, seed=n + d, mutual=True), kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_a1_repeats_bit_for_bit(cuda, kernel, mutual):
    Z, NN, P = _a1_graph(cuda, 70_000, 90, 2, seed=4, mutual=mutual)
    transpose = knn_transpose(NN, P)
    first = tsne_attraction(Z, NN, P, transpose, kernel)
    second = tsne_attraction(Z, NN, P, transpose, kernel)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    grad, loss = tsne_attraction(Z, NN, P, transpose, kernel, grad=False)
    assert grad is None and torch.equal(loss, first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_attraction_function_scales_its_gradient_by_the_cotangent(cuda, kernel):
    """``knn_attraction_loss`` under an early-exaggeration coefficient and
    through a map into Z (an encoder's chain rule), against float64
    autograd of the ``Z[NN]`` gather's cross-entropy on the CPU: within
    1e-4 of the largest entry; the value alone, without a gradient, too."""
    from torchdr_tpu_torch.ops.distance import pairwise_distances_indexed
    from torchdr_tpu_torch.ops.reductions import cross_entropy_loss

    _, NN, P = _a1_graph(cuda, 2_000, 30, 2, seed=5)
    rng = np.random.default_rng(5)
    W = torch.from_numpy(rng.normal(size=(3, 2)))
    X = torch.from_numpy(rng.normal(size=(NN.shape[0], 3)))

    def cross_entropy(Z):
        D = pairwise_distances_indexed(Z, key_indices=NN.cpu(), metric="sqeuclidean")
        return cross_entropy_loss(P.cpu().double(), -torch.log1p(D) if kernel == "student"
                                  else -D, log=True)

    transpose = knn_transpose(NN, P)
    Xc, Wg = X.float().to(cuda), W.float().to(cuda).requires_grad_(True)
    before = tsne_attraction.launches
    got = torch.autograd.grad(12.0 * knn_attraction_loss(Xc @ Wg, P, NN, transpose, kernel),
                              Wg)[0]
    assert tsne_attraction.launches == before + 1
    W64 = W.clone().requires_grad_(True)
    want = torch.autograd.grad(12.0 * cross_entropy(X @ W64), W64)[0]
    assert float((got.cpu().double() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    value = knn_attraction_loss(Xc @ Wg.detach(), P, NN, transpose, kernel)
    want_value = float(cross_entropy(X @ W))
    assert abs(float(value) - want_value) <= 1e-4 * abs(want_value)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("cls", [TSNE, SNE])
def test_fit_on_the_card_launches_a1_every_step_at_every_width(cuda, cls, d):
    """A1 takes every width K2 and K3 take: a fit at n_components 1 or 8
    launches it once a step, beside K2 and K3."""
    rng = np.random.default_rng(2)
    centers = rng.normal(scale=8.0, size=(4, 16))
    X = (centers[rng.integers(0, 4, 1500)] + rng.normal(size=(1500, 16))).astype(np.float32)
    rowlse_fwd.launches = rowlse_bwd.launches = tsne_attraction.launches = 0
    kw = {"lr": 1500 / 12} if cls is SNE else {}
    model = cls(n_components=d, perplexity=20, max_iter=60, random_state=0, **kw)
    Z = model.fit_transform(X)
    assert tsne_attraction.launches == rowlse_fwd.launches == rowlse_bwd.launches == 60
    assert Z.shape == (1500, d) and np.all(np.isfinite(Z))


def _loss_gradients_model(cls, device, arrays, X, encoder=None):
    """A TSNE or SNE (or, for "parametric", a t-SNE with ``encoder``, whose
    starting weights are ``arrays["encoder"]``) holding the pre-loop state
    ``arrays`` on ``device``, and a function of (it, coeff) giving the step's
    gradient through ``_loss_gradients`` (or ``_encoder_gradients``) with
    the constants a fit builds."""
    from torchdr_tpu_torch.utils.interop import load_reference_state

    parametric = cls == "parametric"
    model = TSNE(encoder=encoder, device=device) if parametric else cls(device=device)
    load_reference_state(model, arrays)
    Xd = torch.from_numpy(X).to(device)
    consts = model._build_consts(Xd)
    assert ("in_ptr" in consts) == (device == "cuda")
    if not parametric:
        Z = torch.from_numpy(arrays["init_embedding"]).to(device)
        return lambda it, coeff: model._loss_gradients(Z, consts, {}, it, coeff)[0]
    model._init_embedding(Xd, draw=arrays["encoder"])
    theta, to_Z = model._encoder_map(Xd)
    return lambda it, coeff: model._encoder_gradients(to_Z, theta, consts, {}, it, coeff)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [TSNE, SNE, "parametric"])
def test_loss_gradients_on_the_card_match_the_cpu(cuda, cls):
    """A step's gradient with A1 (and K2, K3) on the card against the CPU
    path, under early exaggeration (step 0, coefficient 12) and after it
    (step 300): within 1e-4 of the largest entry, K3's tolerance."""
    from torchdr_tpu_torch.utils.encoders import init_encoder_variables, make_mlp_encoder

    n, k = 3001, 30
    rng = np.random.default_rng(21)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    NN = np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False) for i in range(n)])
    NN[rng.random((n, k)) < 0.05] = -1
    P = np.where(NN >= 0, rng.random((n, k)), 0.0)
    arrays = {"affinity_in": (P / P.sum()).astype(np.float32), "NN_indices": NN,
              "init_embedding": rng.normal(size=(n, 2)).astype(np.float32)}
    encoder = make_mlp_encoder(2, (16,)) if cls == "parametric" else None
    if encoder is not None:  # one draw of the weights, for both devices
        gen = torch.Generator().manual_seed(0)
        arrays["encoder"] = init_encoder_variables(encoder, torch.from_numpy(X), gen)
    on_card = _loss_gradients_model(cls, "cuda", arrays, X, encoder)
    on_cpu = _loss_gradients_model(cls, "cpu", arrays, X, encoder)
    for it, coeff in ((0, 12.0), (300, 1.0)):
        before = tsne_attraction.launches
        got = on_card(it, coeff).cpu()
        assert tsne_attraction.launches == before + 1
        want = on_cpu(it, coeff)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _hold_general_to_plain(Zq, Z, off, n_total, kernel, exclude_diag=True):
    """The general K2 and K3 on one shard against their plain versions, at
    the square kernels' tolerances; rows past ``n_total`` read −inf (K2)
    and zeros (K3)."""
    before = (rowlse_fwd_general.launches, rowlse_bwd_general.launches)
    lse = rowlse_fwd_general(Zq, Z, off, n_total, kernel, exclude_diag)
    want = rowlse_fwd_general_plain(Zq, Z, off, n_total, kernel, exclude_diag)
    live = max(0, min(Zq.shape[0], n_total - off))
    assert torch.isneginf(lse[live:]).all() and torch.isneginf(want[live:]).all()
    assert float((lse[:live] - want[:live]).abs().max()) <= 1e-5 * max(
        1.0, float(want[:live].abs().max()))
    w = want.clone()
    w[live:] = 0.0
    g = torch.rand(Zq.shape[0], generator=torch.Generator(Zq.device).manual_seed(off),
                   device=Zq.device) / Z.shape[0]
    g[live:] = 0.0
    dq, ddb = rowlse_bwd_general(Zq, Z, off, n_total, w, g, kernel)
    rq, rdb = rowlse_bwd_general_plain(Zq, Z, off, n_total, w, g, kernel)
    assert (rowlse_fwd_general.launches, rowlse_bwd_general.launches) == (
        before[0] + 1, before[1] + 1)
    assert not dq[live:].any() and not ddb[n_total:].any()
    scale = max(float(rq.abs().max()), float(rdb.abs().max()))
    assert float((dq - rq).abs().max()) <= 1e-4 * scale
    assert float((ddb - rdb).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n, world", [(5003, 4), (5001, 4), (3 * 512 + 7, 3), (40, 8)])
def test_general_k2_k3_match_plain_on_every_shard(cuda, kernel, d, n, world):
    """Every shard of Z cut as the sharded row log-sum cuts it: offsets not a
    multiple of the row tile, a padded last shard (rows past n_total, and
    rows of Zq past the end of Zdb), and shards of fewer rows than a tile."""
    rng = np.random.default_rng(n + d)
    Z = torch.from_numpy((3.0 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    chunk = -(-n // world)
    Zp = torch.zeros((chunk * world, d), device=cuda)
    Zp[:n] = Z
    for r in range(world):
        _hold_general_to_plain(Zp[r * chunk : (r + 1) * chunk], Z, r * chunk, n, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_general_k2_k3_mask_columns_past_n_total(cuda, kernel):
    """A database longer than n_total: its rows at or past n_total are
    neither read as columns nor given a gradient; the diagonal kept."""
    rng = np.random.default_rng(5)
    Z = torch.from_numpy((2.0 * rng.normal(size=(900, 2))).astype(np.float32)).to(cuda)
    _hold_general_to_plain(Z[300:700].contiguous(), Z, 300, 800, kernel)
    _hold_general_to_plain(Z[300:700].contiguous(), Z, 300, 800, kernel, exclude_diag=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("n, world", [(3001, 4), (3001, 7), (500, 1)])
def test_sharded_rowlse_on_the_card_matches_the_square_kernels(cuda, kernel, n, world):
    """The sharded row log-sum on a mesh of the one card (a device repeated
    ``world`` times) against K2 and K3: the values within 1e-5 of max(1,
    |value|), the gradient within 1e-4 of its largest entry; the general
    kernels launched once a shard and pass, the square ones never; the same
    result twice."""
    mesh = make_mesh(devices=[cuda] * world)
    rng = np.random.default_rng(n + world)
    Z = torch.from_numpy((2.0 * rng.normal(size=(n, 2))).astype(np.float32)).to(cuda)

    def run(fn):
        Zt = Z.clone().requires_grad_(True)
        out = fn(Zt)
        torch.sin(out).sum().backward()
        return out.detach(), Zt.grad

    before = [f.launches for f in (rowlse_fwd, rowlse_bwd, rowlse_fwd_general,
                                   rowlse_bwd_general)]
    sh, g_sh = run(lambda z: pairwise_logkernel_rowlse_sharded(z, mesh, kernel))
    after = [f.launches for f in (rowlse_fwd, rowlse_bwd, rowlse_fwd_general,
                                  rowlse_bwd_general)]
    assert [a - b for a, b in zip(after, before)] == [0, 0, world, world]
    sq, g_sq = run(lambda z: pairwise_logkernel_rowlse(z, kernel))
    assert float((sh - sq).abs().max()) <= 1e-5 * max(1.0, float(sq.abs().max()))
    assert float((g_sh - g_sq).abs().max()) <= 1e-4 * float(g_sq.abs().max())
    again, g_again = run(lambda z: pairwise_logkernel_rowlse_sharded(z, mesh, kernel))
    assert torch.equal(again, sh) and torch.equal(g_again, g_sh)


def _padded_shards(Z, world):
    n, d = Z.shape
    chunk = -(-n // world)
    Zp = torch.zeros((chunk * world, d), device=Z.device)
    Zp[:n] = Z
    return [(r * chunk, Zp[r * chunk : (r + 1) * chunk]) for r in range(world)]


def _spread_grid(side, spacing, device, seed):
    """Points on a grid ``spacing`` apart: every exp(-d²) underflows."""
    g = torch.arange(side, dtype=torch.float32) * spacing
    Z = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    Z = Z + 0.01 * torch.rand(Z.shape, generator=torch.Generator().manual_seed(seed))
    return Z.contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_one_pass_general_k3_and_k2_match_plain_on_a_padded_last_shard(cuda, kernel, d):
    """The one-pass general K3 (each pair once, its term added to its row
    and its column) and the general K2 on every shard of n = 2,049 rows cut
    4 ways: the last shard padded, the 32-column blocks of the last chunk
    ragged, shards whose rows meet their own columns."""
    rng = np.random.default_rng(40 + d)
    Z = torch.from_numpy((3.0 * rng.normal(size=(2049, d))).astype(np.float32)).to(cuda)
    for off, Zq in _padded_shards(Z, 4):
        _hold_general_to_plain(Zq, Z, off, Z.shape[0], kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_one_pass_general_k3_and_k2_on_the_underflowing_grid(cuda, kernel):
    """A 40 x 40 grid 15 apart: exp(-d²) underflows for every pair, the
    gaussian weights exp(-d² - lse) do not."""
    Z = _spread_grid(40, 15.0, cuda, 3)
    for off, Zq in _padded_shards(Z, 3):
        _hold_general_to_plain(Zq, Z, off, Z.shape[0], kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("exclude_diag", [True, False])
def test_general_k2_sharing_the_own_block_matches_plain(cuda, d, exclude_diag, monkeypatch):
    """The general K2 with the shard's own block shared (each unordered pair
    once, its value added to its row and its column), which the rule takes
    at this small size once its shortest chunk is one block of 32 columns:
    every shard of n = 3,001 cut 4 ways (own blocks of 32 columns above,
    below and across the row tiles, a ragged last one, a padded last shard)
    against the plain version at K2's tolerance, and the same bits twice."""
    monkeypatch.setattr(reduce_kernel, "_SHARED_MIN_CHUNK", reduce_kernel._LANES)
    rng = np.random.default_rng(60 + d)
    n = 3001
    Z = torch.from_numpy((3.0 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    for off, Zq in _padded_shards(Z, 4):
        live = min(Zq.shape[0], n - off)
        assert k2_general_grid(live, n, off, sm_count(cuda.index or 0), d, "student", True)[0]
        got = rowlse_fwd_general(Zq, Z, off, n, "student", exclude_diag, shard_of_db=True)
        want = rowlse_fwd_general_plain(Zq, Z, off, n, "student", exclude_diag)
        assert torch.isneginf(got[live:]).all()
        assert float((got[:live] - want[:live]).abs().max()) <= 1e-5 * max(
            1.0, float(want[:live].abs().max()))
        again = rowlse_fwd_general(Zq, Z, off, n, "student", exclude_diag, shard_of_db=True)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_general_k3_repeats_bit_for_bit_in_two_kernels(cuda, kernel):
    """Both outputs of the general K3 equal bit for bit over two calls (no
    atomics: fixed-order column sums and merge), and a call launches two
    kernels, its pair loop and its merge, as the wrapper counts them."""
    rng = np.random.default_rng(7)
    Z = torch.from_numpy((2.0 * rng.normal(size=(5003, 2))).astype(np.float32)).to(cuda)
    (off, Zq), = _padded_shards(Z, 4)[1:2]
    lse = rowlse_fwd_general_plain(Zq, Z, off, Z.shape[0], kernel)
    g = torch.rand(Zq.shape[0], generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    kernels = rowlse_bwd_general.kernel_launches
    first = rowlse_bwd_general(Zq, Z, off, Z.shape[0], lse, g, kernel)
    assert rowlse_bwd_general.kernel_launches - kernels == 2
    second = rowlse_bwd_general(Zq, Z, off, Z.shape[0], lse, g, kernel)
    assert rowlse_bwd_general.kernel_launches - kernels == 4
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("d", [2, 3])
def test_square_k2_k3_unchanged_beside_the_general_form(cuda, kernel, d):
    """The square kernels keep their own launch: one K2 and one K3 launch a
    call, the general counters untouched, the outputs within the square
    tolerances of the plain versions and the same bits twice."""
    rng = np.random.default_rng(d)
    Z = torch.from_numpy((3.0 * rng.normal(size=(3001, d))).astype(np.float32)).to(cuda)
    general = (rowlse_fwd_general.launches, rowlse_bwd_general.launches,
               rowlse_bwd_general.kernel_launches)
    _hold_k2_k3_to_plain(Z, kernel)
    lse = rowlse_fwd_plain(Z, kernel)
    g = torch.full_like(lse, 1.0 / Z.shape[0])
    assert torch.equal(rowlse_fwd(Z, kernel), rowlse_fwd(Z, kernel))
    assert torch.equal(rowlse_bwd(Z, lse, g, kernel), rowlse_bwd(Z, lse, g, kernel))
    assert (rowlse_fwd_general.launches, rowlse_bwd_general.launches,
            rowlse_bwd_general.kernel_launches) == general


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("sms", ["card", "one"])
def test_square_k2_k3_symmetric_walk_matches_plain(cuda, d, sms, monkeypatch):
    """The square K2 and K3 on the symmetric walk (each unordered pair once,
    its value added to its row and its column), the student mode's walk:
    n = 3,001 (a ragged last row tile, blocks of 32 columns above, below and
    across the row tiles), in chunks of 32 columns on the card's grid, or
    of several blocks of 32 (chunks across a row tile, float32 runs flushed
    within a chunk) on a grid sized for one SM. K2 with the diagonal
    excluded and kept, and K3, against the plain versions at the square
    tolerances; one symmetric launch a call; the same bits twice."""
    if sms == "one":
        monkeypatch.setattr(reduce_kernel, "sm_count", lambda index: 1)
    n = 3001
    for backward in (False, True):
        grid = square_grid(n, reduce_kernel.sm_count(cuda.index or 0), d, "student", backward)
        assert grid[0] and (sms == "card" or grid[2] > reduce_kernel._LANES)
    rng = np.random.default_rng(80 + d)
    Z = torch.from_numpy((3.0 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    before = (*_symmetric_counts(), rowlse_fwd.launches, rowlse_bwd.launches)
    _hold_k2_k3_to_plain(Z, "student")
    assert (*_symmetric_counts(), rowlse_fwd.launches, rowlse_bwd.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 2, before[3] + 1)
    for exclude_diag in (True, False):
        assert torch.equal(rowlse_fwd(Z, "student", exclude_diag),
                           rowlse_fwd(Z, "student", exclude_diag))
    lse = rowlse_fwd_plain(Z, "student")
    g = torch.softmax(lse, 0)
    assert torch.equal(rowlse_bwd(Z, lse, g, "student"), rowlse_bwd(Z, lse, g, "student"))


@pytest.mark.cuda
def test_square_k2_k3_symmetric_walk_at_20000_with_duplicate_rows(cuda):
    """At n = 20,000, d = 2, the card's grid (chunks of several 32-column
    blocks across tiles and chunks), with duplicate rows (d² = 0 off the
    diagonal): K2 and K3 on the symmetric walk against the plain versions
    at the square tolerances."""
    rng = np.random.default_rng(17)
    base = (4.0 * rng.normal(size=(19_000, 2))).astype(np.float32)
    Z = torch.from_numpy(np.concatenate([base, base[:1_000]])).to(cuda)
    assert square_grid(20_000, sm_count(cuda.index or 0), 2, "student")[0]
    before = _symmetric_counts()
    _hold_k2_k3_to_plain(Z, "student")
    assert _symmetric_counts() == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_square_k2_k3_keep_both_orders_past_the_budget_and_for_gaussian(cuda, kernel,
                                                                         monkeypatch):
    """The ordered walk, and the symmetric counters still: the gaussian
    mode, and the student mode where the symmetric walk's scratch would
    pass its budget (set to 0 here)."""
    if kernel == "student":
        monkeypatch.setattr(reduce_kernel, "_SYMMETRIC_SCRATCH_BYTES", 0)
    rng = np.random.default_rng(23)
    Z = torch.from_numpy((3.0 * rng.normal(size=(3001, 2))).astype(np.float32)).to(cuda)
    before = _symmetric_counts()
    assert not square_grid(3001, sm_count(cuda.index or 0), 2, kernel)[0]
    _hold_k2_k3_to_plain(Z, kernel)
    assert _symmetric_counts() == before


@pytest.mark.cuda
def test_tsne_mesh_fit_on_the_card_launches_the_general_kernels(cuda):
    rng = np.random.default_rng(1)
    centers = rng.normal(scale=8.0, size=(4, 16))
    X = (centers[rng.integers(0, 4, 1500)] + rng.normal(size=(1500, 16))).astype(np.float32)
    mesh = make_mesh(devices=[cuda] * 3)
    for f in (rowlse_fwd, rowlse_bwd, rowlse_fwd_general, rowlse_bwd_general, tsne_attraction):
        f.launches = 0
    model = TSNE(perplexity=20, max_iter=120, random_state=0, mesh=mesh)
    Z = model.fit_transform(X)
    assert rowlse_fwd.launches == rowlse_bwd.launches == 0
    assert rowlse_fwd_general.launches == rowlse_bwd_general.launches == 3 * model.n_iter_
    assert tsne_attraction.launches == model.n_iter_  # where Z lives, on the first device
    assert Z.shape == (1500, 2) and np.all(np.isfinite(Z))


GATHERS = {
    "take": (bucket_take, bucket_take_plain),
    "onehot": (bucket_onehot, bucket_onehot_plain),
    "2level": (bucket_2level, bucket_2level_plain),
}


def _hold_gather(name, Zb, idx, **kw):
    """G1-G3 against their plain versions, bit for bit: every output element
    is one term (a gathered value, or a one-hot sum with one nonzero term)."""
    kernel, plain = GATHERS[name]
    before = kernel.launches
    got = kernel(Zb, idx, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + (1 if got.numel() else 0)
    want = plain(Zb, idx, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)


def _gather_inputs(cuda, nb, r, d, c8, seed):
    rng = np.random.default_rng(seed)
    Zb = torch.from_numpy(rng.normal(size=(nb, r, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, r, (nb, 8, c8)).astype(np.int32)).to(cuda)
    if nb and c8:
        idx[0, 0, 0], idx[-1, -1, -1] = 0, r - 1
    return Zb, idx


@pytest.mark.cuda
@pytest.mark.parametrize("nb_c8", [(1, 16), (3, 5), (2, 128)])
@pytest.mark.parametrize("r", [32, 64, 512, 2048])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("name", ["take", "onehot", "2level"])
def test_gather_kernels_match_plain(cuda, name, d, r, nb_c8):
    """Every width; windows of one to 64 groups of 32; ids per window in
    whole and ragged 16-row tiles (c = 40 leaves a warp part of a tile)."""
    nb, c8 = nb_c8
    _hold_gather(name, *_gather_inputs(cuda, nb, r, d, c8, seed=d * r + nb))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 17, 100])
@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("name", ["take", "onehot", "2level"])
def test_gather_kernels_take_any_window(cuda, name, d, r):
    """Windows that are no multiple of 16 (the products' k-step); G3 with
    one group of R rows, and with groups of one row."""
    Zb, idx = _gather_inputs(cuda, 2, r, d, 16, seed=r + d)
    if name == "2level":
        for grp in (r, 1):
            _hold_gather(name, Zb, idx, grp=grp)
    else:
        _hold_gather(name, Zb, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("name, r, grp", [
    ("onehot", 4000, None), ("onehot", 14_512, None), ("2level", 8192, 32), ("2level", 4096, 8),
])
def test_gather_windows_above_48_kb_of_shared_memory(cuda, name, r, grp):
    """Staged windows beyond the default 48 KB of shared memory: the
    attribute is raised before the launch."""
    Zb, idx = _gather_inputs(cuda, 2, r, 8, 64, seed=r)
    _hold_gather(name, Zb, idx, **({} if grp is None else {"grp": grp}))


@pytest.mark.cuda
def test_gather_windows_beyond_shared_memory_are_refused(cuda):
    Zb, idx = _gather_inputs(cuda, 1, 14_528, 8, 4, seed=0)
    before = bucket_onehot.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        bucket_onehot(Zb, idx)
    assert bucket_onehot.launches == before
    assert torch.equal(bucket_take(Zb, idx), bucket_take_plain(Zb, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["take", "onehot", "2level"])
def test_gather_clamps_ids_to_the_window(cuda, name):
    Zb, idx = _gather_inputs(cuda, 3, 64, 5, 16, seed=1)
    idx[0, 0, :3] = torch.tensor([-1, 64, 2**31 - 1], dtype=torch.int32)
    idx[2, 7, -2:] = torch.tensor([-(2**31), 1000], dtype=torch.int32)
    _hold_gather(name, Zb, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("nb, c8", [(0, 16), (4, 0)])
@pytest.mark.parametrize("name", ["take", "onehot", "2level"])
def test_gather_empty_input(cuda, name, nb, c8):
    _hold_gather(name, *_gather_inputs(cuda, nb, 64, 2, c8, seed=2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["take", "onehot", "2level"])
def test_gather_rejects_wide_rows_on_the_card(cuda, name):
    Zb = torch.zeros((1, 64, 9), device=cuda)
    with pytest.raises(ValueError, match="D <= 8"):
        GATHERS[name][0](Zb, torch.zeros((1, 8, 2), dtype=torch.int32, device=cuda))


def _walk_ids(kind, nb, r, c, seed):
    """Window-local ids (nb, 8, c / 8) int32 that drive the gathers' walks
    to their edges. G2 visits only the k-steps (16 window rows) that a
    16-row tile's ids hit; G3 only the column tiles that hold a row's
    member of its group of 32. Row k of a tile is id k % 16 of its window."""
    i = np.arange(c)[None, :] + 7 * np.arange(nb)[:, None]
    if kind == "one k-step":  # every id in window rows 0-15
        ids = i % 16
    elif kind == "every k-step":  # a tile's 16 rows on 16 different k-steps
        ids = (16 * i + i % 16) % r
    elif kind == "k-step edges":
        ids = np.array([0, 15, 16, 31, 32, r - 17, r - 16, r - 1])[i % 8]
    elif kind == "one member":  # a tile's rows: member 5 of their group
        ids = (i // 16) % (r // 32) * 32 + 5
    elif kind == "every member":  # each member of each group, 16 a tile
        ids = i % r
    else:  # uniform
        ids = np.random.default_rng(seed).integers(0, r, (nb, c))
    return ids.astype(np.int32).reshape(nb, 8, c // 8)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [512, 1024, 2048])
@pytest.mark.parametrize("d", [3, 8])
@pytest.mark.parametrize(
    "kind", ["one k-step", "every k-step", "k-step edges", "one member", "every member"])
@pytest.mark.parametrize("name", ["take", "onehot", "2level"])
def test_gather_walk_edge_cases(cuda, name, kind, d, r):
    """Ids all inside one k-step, a tile's 16 rows on 16 k-steps, ids at the
    k-steps' edges; for G3 every row of a tile in one member, and every
    member hit. R = 1024 and 2048 give G3 two and four stage-1 k-steps
    (grp = 32) and G2 32 or 128 k-steps, more than one 32-bit word."""
    rng = np.random.default_rng(r + d)
    Zb = torch.from_numpy(rng.normal(size=(6, r, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(_walk_ids(kind, 6, r, 1024, seed=r)).to(cuda)
    _hold_gather(name, Zb, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("c8", [1, 3, 5, 127])
@pytest.mark.parametrize("r", [512, 2048])
@pytest.mark.parametrize("name", ["take", "onehot", "2level"])
def test_gather_ragged_c(cuda, name, r, c8):
    """c = 8, 24, 40 and 1,016 ids: the last tile of a window is a part
    tile, and with c = 8 a warp holds rows of no tile past c."""
    Zb, idx = _gather_inputs(cuda, 5, r, 8, c8, seed=r + c8)
    _hold_gather(name, Zb, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("r, grp, d", [
    (1024, 1, 8), (2048, 2, 8), (1024, 32, 8), (512, 512, 8), (512, 512, 3), (2048, 64, 1),
])
@pytest.mark.parametrize("kind", ["uniform", "every k-step", "k-step edges"])
def test_2level_walks_past_one_word(cuda, r, grp, d, kind):
    """G3 with more than 32 stage-1 k-steps (R / grp = 1024 groups: 64
    k-steps), two k-steps (R = 1024, grp = 32), and more than 32 column
    tiles (one group of 512 rows: 512 column tiles at D = 8)."""
    rng = np.random.default_rng(grp + r)
    Zb = torch.from_numpy(rng.normal(size=(3, r, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(_walk_ids(kind, 3, r, 512, seed=grp)).to(cuda)
    _hold_gather("2level", Zb, idx, grp=grp)


@pytest.mark.cuda
def test_gather_windows_at_an_unaligned_address(cuda):
    """A window tensor that starts 4 bytes past a 16-byte boundary: the
    staging reads it by single floats instead of float4."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.normal(size=(1 + 2 * 64 * 8,)).astype(np.float32)).to(cuda)
    Zb = base[1:].view(2, 64, 8)
    assert Zb.is_contiguous() and Zb.data_ptr() % 16 == 4
    idx = torch.from_numpy(_walk_ids("uniform", 2, 64, 64, seed=5)).to(cuda)
    for name in ("take", "onehot", "2level"):
        _hold_gather(name, Zb, idx)


def _ivf_data(n, d, n_clusters, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    X = centers[rng.integers(0, n_clusters, n)] + rng.normal(size=(n, d))
    return (X - X.mean(0)).astype(np.float32)


def _tight_ivf_data(groups, per_group, per_cluster, d, seed):
    """Tight clusters in well-separated groups: no row near a cell boundary,
    so float32 k-means steps agree between devices (the card sums the
    centroids by atomic adds in no fixed order). The clusters of a group sit
    at distinct radii from its centre, 0.25 apart: the supers' relabel sorts
    cells by that distance, which float32 rounds at ~1e-3 here."""
    rng = np.random.default_rng(seed)
    g = rng.normal(scale=20.0, size=(groups, d))
    u = rng.normal(size=(groups * per_group, d))
    radii = 1.0 + 0.25 * np.tile(np.arange(per_group), groups)
    c = np.repeat(g, per_group, 0) + (radii / np.linalg.norm(u, axis=1))[:, None] * u
    X = np.repeat(c, per_cluster, 0) + rng.normal(scale=0.05, size=(len(c) * per_cluster, d))
    return X.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters, kw", [(300, dict(chunk=64)), (2048, dict(kmeans_iters=5))])
def test_ivf_build_on_the_card_equals_the_cpu(cuda, n_clusters, kw, record_property):
    """The same index on the card as on the CPU from the same generator
    seed and the same k-means seedings: layout equal, X_sorted bit for bit,
    centroids within 1e-5 absolute plus 1e-5 relative (the card adds a
    cluster's coordinates by atomic adds in no fixed order: a few float32
    rounding steps of the sum, relative to the coordinate). The largest
    centroid gap, the largest coordinate and the largest share of the bound
    taken go to the JUnit report (``--junitxml``)."""
    from torchdr_tpu_torch.ops.ivf import IVFIndex, ivf_build

    X = (_tight_ivf_data(10, 30, 20, 12, 0) if n_clusters == 300
         else _tight_ivf_data(32, 64, 8, 8, 1))
    # one row of each cluster (rows are sorted by cluster) seeds the cells,
    # and the group means the 32 supers of the 2048 cells
    init = torch.from_numpy(X[:: X.shape[0] // n_clusters][:n_clusters].copy())
    sup = torch.from_numpy(X.reshape(32, -1, X.shape[1]).mean(1)) if n_clusters == 2048 else None
    idx = {}
    for dev in ("cpu", cuda):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        idx[str(dev)] = ivf_build(torch.from_numpy(X).to(dev), n_clusters=n_clusters, generator=g,
                                  init_centers=init.to(dev),
                                  super_init=None if sup is None else sup.to(dev), **kw)
    cpu, card = idx["cpu"], idx[str(cuda)]
    assert card.X_sorted.is_cuda and card.cell_adj.is_cuda
    for name in IVFIndex._fields:
        a, b = getattr(cpu, name), getattr(card, name)
        if not isinstance(a, torch.Tensor):
            assert a == b, name
        elif name in ("centroids", "super_centroids"):
            gap = (a - b.cpu()).abs()
            record_property(f"{name}_max_abs_gap", float(gap.max()))
            record_property(f"{name}_max_abs", float(a.abs().max()))
            record_property(f"{name}_share_of_bound", float((gap / (1e-5 + 1e-5 * a.abs())).max()))
            assert torch.allclose(a, b.cpu(), atol=1e-5, rtol=1e-5), name
        elif name != "cell_adj":  # its order of equidistant cells may differ
            assert torch.equal(a, b.cpu()), name
    assert torch.equal(torch.sort(cpu.cell_adj, 1).values, torch.sort(card.cell_adj.cpu(), 1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(), dict(rerank=False, nomination="adjacency"), dict(merge="tournament", block=48),
    dict(merge="exact", budget_order="rank", budget=6), dict(seg_rows=1000),
])
def test_ivf_search_on_the_card_equals_the_cpu(cuda, kw):
    """One CPU-built index searched on the CPU and, moved over, on the
    card: the same ids up to ties, distances within 1e-5 absolute plus 1e-5
    relative (of |q|² + |x|² for the scan scores of ``rerank=False``)."""
    from torchdr_tpu_torch.ops.ivf import index_from_numpy, ivf_build, ivf_knn, ivf_knn_queries

    X = _ivf_data(6000, 12, 30, seed=0)
    cpu = ivf_build(torch.from_numpy(X), n_clusters=300, kmeans_iters=8, chunk=64)
    card = index_from_numpy({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                             for k, v in cpu._asdict().items()}, cuda)
    for search in (lambda i: ivf_knn(None, index=i, k=10, nprobe=8, **kw),
                   lambda i: ivf_knn_queries(torch.from_numpy(X[::5] + 0.01).to(i.X_sorted.device),
                                             i, k=10, nprobe=8, **kw)):
        wd, wi = search(cpu)
        gd, gi = search(card)
        assert gi.is_cuda and gi.dtype == torch.int32
        gd, gi = gd.cpu().double().numpy(), gi.cpu().numpy()
        wd, wi = wd.double().numpy(), wi.numpy()
        norms = (X.astype(np.float64) ** 2).sum(1)
        scale = np.abs(wd) if kw.get("rerank", True) else np.abs(wd) + 2 * norms.max()
        assert np.all(np.abs(gd - wd) <= 1e-5 + 1e-5 * scale)
        for r, j in zip(*np.nonzero(gi != wi)):
            tie = np.abs(wd[r] - wd[r, j]) <= 2e-5 * np.maximum(1.0, scale[r, j])
            assert j == wi.shape[1] - 1 or tie.sum() > 1, (r, j)
        assert (gi != wi).mean() < 1e-3


@pytest.mark.cuda
def test_ivf_affinity_on_a_cuda_tensor_stays_on_the_card(cuda, monkeypatch):
    """``knn_mode="ivf"`` on a CUDA tensor: the index is built and searched
    on the card; neither the host-segmented assignment nor a host permute
    runs."""
    from torchdr_tpu_torch import IVF, UMAPAffinity
    from torchdr_tpu_torch.ops import ivf as tivf

    def host_path(*a, **k):
        raise AssertionError("the host-segmented assignment ran")

    devices = []
    index_copy = torch.Tensor.index_copy_

    def spy(self, *a, **k):
        devices.append(self.device.type)
        return index_copy(self, *a, **k)

    monkeypatch.setattr(tivf, "_assign_host_segmented", host_path)
    monkeypatch.setattr(torch.Tensor, "index_copy_", spy)
    X = torch.from_numpy(_ivf_data(5000, 16, 20, seed=3)).to(cuda)
    P, NN = UMAPAffinity(n_neighbors=15, knn_mode=IVF, device="auto")(X, return_indices=True)
    assert P.is_cuda and NN.is_cuda and bool(torch.isfinite(P).all())
    assert devices and set(devices) == {"cuda"}


@pytest.mark.cuda
def test_ivf_build_on_a_cuda_tensor_never_permutes_on_the_host(cuda, monkeypatch):
    """With the card's memory budget forced to nothing, a CUDA tensor is
    still assigned and permuted on the card (or the card raises): the host
    permute is for numpy input only. The index equals the one built with
    the true budget (centroids within 1e-5 absolute plus 1e-5 relative: the
    card's k-means sums are atomic adds in no fixed order; ``cell_adj`` up
    to the order of equidistant cells, as the card-against-CPU test)."""
    from torchdr_tpu_torch.ops import ivf as tivf

    X = torch.from_numpy(_tight_ivf_data(10, 30, 20, 12, 0)).to(cuda)
    init = X[:: X.shape[0] // 300][:300].clone()

    def build():
        g = torch.Generator(device=cuda)
        g.manual_seed(0)
        return tivf.ivf_build(X, n_clusters=300, generator=g, init_centers=init, chunk=64)

    want = build()
    devices = []
    index_copy = torch.Tensor.index_copy_

    def spy(self, *a, **k):
        devices.append(self.device.type)
        return index_copy(self, *a, **k)

    def host_path(*a, **k):
        raise AssertionError("the host-segmented assignment ran")

    monkeypatch.setattr(tivf, "_permute_hbm_budget", lambda device: 0)
    monkeypatch.setattr(tivf, "_assign_host_segmented", host_path)
    monkeypatch.setattr(torch.Tensor, "index_copy_", spy)
    got = build()
    assert devices == ["cuda"]
    for name in tivf.IVFIndex._fields:
        a, b = getattr(want, name), getattr(got, name)
        if not isinstance(a, torch.Tensor):
            assert a == b, name
        elif name in ("centroids", "super_centroids"):
            assert b.is_cuda and torch.allclose(a, b, atol=1e-5, rtol=1e-5), name
        elif name == "cell_adj":
            assert b.is_cuda and torch.equal(torch.sort(a, 1).values, torch.sort(b, 1).values)
        else:
            assert b.is_cuda and torch.equal(a, b), name


# --- LargeVis, InfoTSNE, PACMAP, TSNEkhorn and their affinities ---------------
#
# None of them has a kernel of its own. On the card each is held to its CPU
# run at the CPU tests' tolerances (tests/test_torch_ot_affinity.py,
# test_torch_largevis.py, test_torch_pacmap.py, test_torch_tsnekhorn.py),
# and each fit launches no kernel.


def _ne_data(n=600, d=16, k=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(k, d))
    return (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)


def _affinities():
    from torchdr_tpu_torch import (
        DoublyStochasticQuadraticAffinity,
        NormalizedGaussianAffinity,
        NormalizedStudentAffinity,
        SinkhornAffinity,
        SymmetricEntropicAffinity,
    )

    return {
        # the CPU test's converging setting (343 steps): a solve cut off by
        # max_iter leaves its trajectory's rounding in P (2.1e-4 on n·P here)
        "sea_adam": (lambda dev: SymmetricEntropicAffinity(perplexity=12, zero_diag=False,
                                                           device=dev), 1e-5),
        "sea_lbfgs": (lambda dev: SymmetricEntropicAffinity(
            perplexity=12, optimizer="LBFGS", lr=0.5, max_iter=300, device=dev), 1e-4),
        "sinkhorn": (lambda dev: SinkhornAffinity(base_kernel="student", device=dev), 1e-5),
        "gaussian": (lambda dev: NormalizedGaussianAffinity(normalization_dim=1, device=dev), 1e-5),
        "student": (lambda dev: NormalizedStudentAffinity(device=dev), 1e-5),
        "quadratic": (lambda dev: DoublyStochasticQuadraticAffinity(lr=1e-1, max_iter=2000,
                                                                    device=dev), 1e-5),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sea_adam", "sea_lbfgs", "sinkhorn", "gaussian", "student",
                                  "quadratic"])
def test_ot_affinity_on_the_card_equals_the_cpu(cuda, name):
    """n·P at the CPU tests' tolerance (1e-5; the SEA's LBFGS branch 1e-4
    on P, whose line search amplifies rounding)."""
    make, tol = _affinities()[name]
    X = np.random.default_rng(0 if name == "sea_adam" else 1).normal(size=(100, 6)).astype(
        np.float32)
    n = X.shape[0]
    want = make("cpu")(X)
    got = make(cuda.type)(torch.from_numpy(X).to(cuda))
    assert got.is_cuda and bool(torch.isfinite(got).all())
    scale = 1.0 if name == "sea_lbfgs" else n
    assert float((scale * (got.cpu() - want)).abs().max()) <= tol


@pytest.mark.cuda
def test_pacmap_affinity_on_the_card_equals_the_cpu(cuda):
    from torchdr_tpu_torch import PACMAPAffinity

    X = np.random.default_rng(0).normal(size=(300, 12)).astype(np.float32)
    cpu, card = PACMAPAffinity(n_neighbors=8, device="cpu"), PACMAPAffinity(n_neighbors=8,
                                                                          device=cuda.type)
    _, want = cpu(X)
    _, got = card(torch.from_numpy(X).to(cuda))
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert torch.allclose(card.rho_.cpu(), cpu.rho_, rtol=1e-5, atol=0)


def _pre_loop(model, X, device):
    """A port estimator's pre-loop state on ``device``, as its fit makes it."""
    Xd = torch.from_numpy(X).to(device)
    model.device_ = Xd.device
    model.n_samples_in_, model.n_features_in_ = X.shape
    model._generator_ = model._root_generator()
    model._compute_input_affinity(Xd)
    model.on_affinity_computation_end()
    Z0 = model._init_embedding(Xd)
    consts = model._build_consts(Xd)
    return Z0, consts, model._init_carry(consts)


def _ne_models():
    from torchdr_tpu_torch import PACMAP, InfoTSNE, LargeVis, TSNEkhorn

    return {
        "LargeVis": lambda dev, **kw: LargeVis(perplexity=10, random_state=0, device=dev, **kw),
        "LargeVis-per-point": lambda dev, **kw: LargeVis(
            perplexity=10, random_state=0, shared_negatives=False, device=dev, **kw),
        "InfoTSNE": lambda dev, **kw: InfoTSNE(perplexity=10, n_negatives=30, random_state=0,
                                               device=dev, **kw),
        "PACMAP": lambda dev, **kw: PACMAP(n_neighbors=8, iter_per_phase=10, random_state=0,
                                           device=dev, **kw),
        "TSNEkhorn": lambda dev, **kw: TSNEkhorn(perplexity=10, random_state=0, device=dev, **kw),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["LargeVis", "LargeVis-per-point", "InfoTSNE", "PACMAP",
                                  "TSNEkhorn"])
def test_ne_step_on_the_card_equals_the_cpu(cuda, name):
    """One step's loss and gradient on the card against the CPU, from the
    CPU's pre-loop state and draws moved to the card (the affinities are
    held card against CPU above): the loss at 1e-5 relative, the gradient
    at 1e-5 absolute, the CPU tests' one-step tolerances."""
    X = _ne_data(n=300)
    m = _ne_models()[name]("cpu")
    _, consts, carry = _pre_loop(m, X, "cpu")
    n = X.shape[0]
    g = torch.Generator().manual_seed(5)
    draw = {}
    if name == "PACMAP":
        draw["cand"] = torch.randint(0, n - 1, (m.n_mid_near, n, 6), generator=g)
    if name != "TSNEkhorn":
        if m.shared_negatives and name != "PACMAP":
            draw["neg_ids"] = torch.randint(0, n, (m._shared_negative_count(n),), generator=g)
        else:
            draw["u"] = torch.rand((n, m.n_negatives), generator=g)
    Z = torch.from_numpy((2.0 * np.random.default_rng(3).normal(size=(n, 2))).astype(np.float32))

    def on(dev, tree):
        return {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

    results = []
    for dev in ("cpu", cuda):
        Zg = Z.to(dev).requires_grad_(True)
        c, cy, dr = on(dev, consts), on(dev, carry), on(dev, draw)
        it = 3
        if name == "TSNEkhorn":
            loss, _ = m._loss(Zg, c, cy, it, 1.0)
        else:
            attr, cy = m._attractive_loss(Zg, c, cy, it, **({"cand": dr.pop("cand")}
                                                            if "cand" in dr else {}))
            rep, _ = m._repulsive_loss(Zg, c, cy, it, **dr)
            loss = attr + rep
        (grad,) = torch.autograd.grad(loss, Zg)
        assert grad.device.type == torch.device(dev).type
        results.append((float(loss), grad.cpu()))
    (lc, gc), (lg, gg) = results
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert float((gg - gc).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["LargeVis", "LargeVis-per-point", "InfoTSNE", "PACMAP",
                                  "TSNEkhorn"])
def test_ne_fit_on_the_card_launches_no_kernel(cuda, name):
    counters = (fused_shared_repulsion, rowlse_fwd, rowlse_bwd, bucket_take, bucket_onehot,
                bucket_2level, tsne_attraction)
    for fn in counters:
        fn.launches = 0
    model = _ne_models()[name](cuda.type, max_iter=60)
    Z = model.fit_transform(_ne_data(n=1500))
    assert model.n_iter_ > 0 and Z.shape == (1500, 2) and np.all(np.isfinite(Z))
    assert {fn.__name__: fn.launches for fn in counters} == {fn.__name__: 0 for fn in counters}


def _spectral_data(n=600, d=12, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(6, d))
    return (centers[rng.integers(0, 6, n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["IncrementalPCA", "ExactIncrementalPCA"])
def test_incremental_pca_on_the_card_equals_the_cpu(cuda, name):
    """Components up to sign and projections at 1e-5 of the largest entry,
    the CPU tests' tolerance; the card's SVD is cuSOLVER's ``gesvd``."""
    import torchdr_tpu_torch as tdt

    X = _spectral_data()
    cpu = getattr(tdt, name)(n_components=4, batch_size=100, device="cpu")
    card = getattr(tdt, name)(n_components=4, batch_size=100, device=cuda.type)
    want = cpu.fit_transform(X)
    got = card.fit_transform(torch.from_numpy(X).to(cuda))
    assert got.is_cuda and card.components_.is_cuda
    signs = torch.sign(torch.sum(card.components_.cpu() * cpu.components_, dim=1))
    assert float((card.components_.cpu() * signs[:, None] - cpu.components_).abs().max()) <= 1e-5
    scale = float(np.abs(want).max())
    assert float((got.cpu() * signs[None, :] - torch.from_numpy(want)).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["eigh", "lobpcg-matrix-free", "lobpcg-dense"])
def test_kernel_pca_on_the_card_equals_the_cpu(cuda, solver):
    """Eigenvalues at 1e-5 of λ₁ from the same LOBPCG start, the same
    iteration count (1 apart at most: the card's products round otherwise)."""
    from torchdr_tpu_torch import KernelPCA, NormalizedGaussianAffinity, SelfTuningAffinity

    X = _spectral_data(n=800)

    def make(dev):
        aff = (SelfTuningAffinity(normalization_dim=None, device=dev) if solver == "lobpcg-dense"
               else NormalizedGaussianAffinity(sigma=100.0, normalization_dim=None, device=dev))
        return KernelPCA(affinity=aff, solver=solver.split("-")[0], random_state=0, device=dev)

    X0 = torch.from_numpy(np.random.default_rng(1).normal(size=(800, 2)).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        m = make(torch.device(dev).type)
        Xd = torch.from_numpy(X).to(dev)
        if solver == "eigh":
            m.fit_transform(Xd)
            lam = m.eigenvalues_[:2]
        elif solver == "lobpcg-dense":
            lam, _ = m._lobpcg_dense(m.affinity(Xd), X0=X0.to(dev))
        else:
            lam, _ = m._lobpcg_matfree(Xd, m._kernel_block_fn(), X0=X0.to(dev))
        out.append((lam.cpu(), m.lobpcg_iterations_ if solver != "eigh" else 0))
    (lc, ic), (lg, ig) = out
    assert float((lg - lc).abs().max()) <= 1e-5 * float(lc[0]) and abs(ig - ic) <= 1


@pytest.mark.cuda
def test_phate_and_affinities_on_the_card_equal_the_cpu(cuda):
    """The three affinities at the CPU tests' tolerances, and a PHATE fit
    (60 steps) launching no kernel."""
    from torchdr_tpu_torch import PHATE, MAGICAffinity, PHATEAffinity, SelfTuningAffinity

    X = _spectral_data(n=300)
    for make, tol in ((lambda d: SelfTuningAffinity(device=d), 5e-6),
                      (lambda d: MAGICAffinity(device=d), 5e-6),
                      (lambda d: PHATEAffinity(t=20, device=d), None)):
        want = make("cpu")(X)
        got = make(cuda.type)(torch.from_numpy(X).to(cuda)).cpu()
        tol = 1e-3 * float(want.abs().max()) if tol is None else tol
        assert float((got - want).abs().max()) <= tol
    counters = (fused_shared_repulsion, rowlse_fwd, rowlse_bwd, bucket_take, bucket_onehot,
                bucket_2level)
    for fn in counters:
        fn.launches = 0
    Z = PHATE(t=20, max_iter=60, random_state=0, device=cuda.type).fit_transform(X)
    assert Z.shape == (300, 2) and np.all(np.isfinite(Z))
    assert all(fn.launches == 0 for fn in counters)


@pytest.mark.cuda
def test_eval_on_the_card_equals_the_cpu(cuda):
    from torchdr_tpu_torch import eval as teval

    X = _spectral_data(n=500)
    y = np.random.default_rng(2).integers(0, 6, 500)
    Z = X[:, :2].copy()
    for fn in (lambda d: teval.knn_label_accuracy(X, y, device=d),
               lambda d: teval.neighborhood_preservation(X, Z, K=10, device=d),
               lambda d: teval.neighborhood_preservation_sampled(X, Z, K=10, n_queries=100,
                                                                 device=d)):
        assert fn(cuda.type) == pytest.approx(fn("cpu"), abs=1e-6)
    assert teval.silhouette_score(X, y, device=cuda.type) == pytest.approx(
        teval.silhouette_score(X, y, device="cpu"), abs=1e-5)
    ari, pred = teval.kmeans_ari(X, y, random_state=0, device=cuda.type)
    assert np.isfinite(ari) and pred.shape == (500,)


# --- the optimization engine: encoders, bands, COSNE, root search ---


def _engine_data(n=1500, d=16, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(4, d))
    labels = rng.integers(0, 4, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32), labels


def _zero_counters():
    counters = (fused_shared_repulsion, rowlse_fwd, rowlse_bwd, rowlse_fwd_general,
                rowlse_bwd_general, tsne_attraction)
    for fn in counters:
        fn.launches = 0
    return counters


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["UMAP", "TSNE"])
def test_parametric_fit_on_the_card_launches_its_kernels_every_step(cuda, model):
    """With ``encoder=`` the weights live on the card, the encoder runs there,
    and the estimator's kernels launch once a step: K1 for UMAP, K2 and K3
    for t-SNE (the chain rule through the encoder)."""
    from torchdr_tpu_torch.utils.encoders import make_mlp_encoder

    X, _ = _engine_data()
    _zero_counters()
    cls = UMAP if model == "UMAP" else TSNE
    est = cls(max_iter=40, random_state=0, optimizer="Adam", lr=1e-3,
              encoder=make_mlp_encoder(2, (32,)))
    Z = est.fit_transform(X)
    assert Z.shape == (1500, 2) and np.all(np.isfinite(Z)) and est.n_iter_ == 40
    if model == "UMAP":
        assert fused_shared_repulsion.launches == 40
        assert rowlse_fwd.launches == rowlse_bwd.launches == tsne_attraction.launches == 0
    else:
        assert rowlse_fwd.launches == rowlse_bwd.launches == tsne_attraction.launches == 40
        assert fused_shared_repulsion.launches == 0
    assert all(v.device.type == "cuda" for v in est.encoder_variables_.values())
    Zt = est.transform(torch.from_numpy(X[:100]).to(cuda))
    assert Zt.device.type == "cuda"
    assert float((Zt.cpu() - torch.from_numpy(Z[:100])).abs().max()) <= 1e-5
    assert isinstance(est.transform(X[:10]), np.ndarray)


@pytest.mark.cuda
def test_bands_fit_on_the_card_launches_k1_every_step(cuda):
    X, _ = _engine_data(seed=4)
    _zero_counters()
    est = UMAP(n_neighbors=15, max_iter=70, random_state=0, edge_schedule="bands")
    Z = est.fit_transform(X)
    assert fused_shared_repulsion.launches == est.n_iter_ == 70
    assert Z.shape == (1500, 2) and np.all(np.isfinite(Z))
    widths = est.band_widths_  # prefix widths, the last the graph's full width
    assert len(widths) == 7 and list(widths) == sorted(widths) and widths[0] >= 8


@pytest.mark.cuda
def test_cosne_on_the_card_stays_in_the_ball_and_launches_no_kernel(cuda):
    from torchdr_tpu_torch import COSNE

    X, _ = _engine_data(n=600, seed=5)
    counters = _zero_counters()
    Z = COSNE(perplexity=20, max_iter=60, random_state=0, block_size=256).fit_transform(X)
    assert Z.shape == (600, 2) and np.all(np.isfinite(Z))
    assert float(np.linalg.norm(Z, axis=1).max()) < 1.0
    assert all(fn.launches == 0 for fn in counters)


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_diag", [True, False])
def test_autodiff_rowlse_on_the_card_matches_the_cpu(cuda, exclude_diag):
    """The blockwise autodiff row log-sum on the card against the CPU in
    float64, value and gradient, at n not a multiple of the block."""
    import math

    from torchdr_tpu_torch.ops.reduce import pairwise_logkernel_rowlse_autodiff

    rng = np.random.default_rng(6)
    Z = rng.normal(size=(1003, 2)) * 0.2

    def run(Zt):
        Zt = Zt.clone().requires_grad_(True)
        lse = pairwise_logkernel_rowlse_autodiff(
            Zt, lambda D: math.log(2.0) - torch.log(D + 4.0), metric="sqhyperbolic",
            exclude_diag=exclude_diag, block_size=256)
        (g,) = torch.autograd.grad(torch.logsumexp(lse, 0), Zt)
        return lse.detach().cpu().double(), g.cpu().double()

    got, got_g = run(torch.from_numpy(Z.astype(np.float32)).to(cuda))
    want, want_g = run(torch.from_numpy(Z))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((got_g - want_g).abs().max()) <= 1e-4 * float(want_g.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["binary_search", "false_position"])
def test_root_search_with_scalar_bounds_runs_on_the_card(cuda, name):
    from torchdr_tpu_torch.ops import root_search

    target = torch.linspace(0.5, 4.0, 33, device=cuda)
    root = getattr(root_search, name)(lambda x: torch.log(x) - torch.log(target), 33)
    assert root.device.type == "cuda"
    assert float((root - target).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_checkpoint_of_a_cpu_fit_loads_onto_the_card(cuda, tmp_path):
    """A checkpoint saved from a CPU fit loads into ``device="auto"``: the
    fitted arrays on the card, ``transform`` there within 1e-5 of the
    CPU's (another GEMM summation order)."""
    from torchdr_tpu_torch import PCA
    from torchdr_tpu_torch.utils import load_estimator, save_estimator

    X = np.random.default_rng(8).normal(size=(500, 12)).astype(np.float32)
    model = PCA(n_components=3, device="cpu")
    model.fit_transform(X)
    save_estimator(model, str(tmp_path / "pca"))
    fresh = load_estimator(PCA(n_components=3), str(tmp_path / "pca"))
    assert fresh.device_.type == "cuda" and fresh.mean_.device.type == "cuda"
    assert fresh.embedding_.device.type == "cuda"
    Xt = torch.from_numpy(X).to(cuda)
    got = fresh.transform(Xt)
    assert got.device.type == "cuda"
    assert float((got.cpu() - torch.from_numpy(model.transform(X))).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_device_trace_sees_k1_once_a_step(cuda, tmp_path):
    """A UMAP fit under ``device_trace``: the trace holds one K1 kernel
    event (``repulsion_kernel``) per launch the wrapper counted."""
    import glob
    import json

    from torchdr_tpu_torch.utils import device_trace

    rng = np.random.default_rng(9)
    X = (rng.normal(scale=4.0, size=(4, 16))[rng.integers(0, 4, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    model = UMAP(random_state=0, max_iter=20)
    before = fused_shared_repulsion.launches
    with device_trace(str(tmp_path / "trace")):
        model.fit_transform(X)
    launches = fused_shared_repulsion.launches - before
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"
               and "repulsion_kernel" in e.get("name", "")]
    assert launches == model.n_iter_ > 0
    assert len(kernels) == launches


ROW_HASH_SHAPES = [(1_300_000, 50), (70_000, 784), (1, 1), (129, 50), (1_000, 3), (1_000, 33),
                   (1_000, 36), (513, 785), (300, 1_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROW_HASH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_row_hash_is_the_host_hash_bit_for_bit(cuda, shape):
    """The row-hash kernel gives ``_row_hashes``' uint64 hashes exactly, at
    the benchmark's two shapes and at widths on either side of its chunk of
    32 words and of a 16-byte group, on a contiguous tensor, a view that
    starts a word into its storage and a strided one; one launch a call."""
    from torchdr_tpu_torch.ops.cuda.hash_kernel import row_hash
    from torchdr_tpu_torch.utils.wrappers import _row_hashes

    n, m = shape
    rng = np.random.default_rng(n + m)
    X = rng.normal(size=(n, m + 1)).astype(np.float32)
    X[: n // 3, :m] = 0.0
    X[n // 3: 2 * (n // 3), :m] = -0.0
    want = _row_hashes(X[:, :m])
    flat = torch.from_numpy(np.concatenate([[0.0], X[:, :m].ravel()]).astype(np.float32)).to(cuda)
    for view in (torch.from_numpy(np.ascontiguousarray(X[:, :m])).to(cuda),
                 flat[1:].view(n, m), torch.from_numpy(X).to(cuda)[:, :m]):
        before = row_hash.launches
        got = row_hash(view).cpu().numpy().view(np.uint64)
        assert row_hash.launches == before + 1
        assert np.array_equal(got, want)


def _clustered_with(n_dup, seed):
    rng = np.random.default_rng(seed)
    X = (rng.normal(scale=4.0, size=(4, 16))[rng.integers(0, 4, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    if n_dup:
        X[-n_dup:] = X[:n_dup]
    return X


@pytest.mark.cuda
def test_row_hash_launches_once_a_cuda_fit(cuda):
    """A CUDA fit of distinct rows decides on the card: one row-hash launch,
    no numpy row sort, the fit's input the copy already there."""
    from torchdr_tpu_torch.ops.cuda.hash_kernel import row_hash
    from torchdr_tpu_torch.utils.wrappers import deduplicate

    X = _clustered_with(0, 10)
    launches, exact = row_hash.launches, deduplicate.exact_calls
    model = UMAP(random_state=0, max_iter=20)
    model.fit_transform(X)
    assert row_hash.launches == launches + 1
    assert deduplicate.exact_calls == exact
    assert model.n_samples_in_ == X.shape[0]
    assert [k for k in model.timings_ if k.startswith("api.")] == [
        "api.check", "api.h2d", "api.dedup", "api.d2h"]


@pytest.mark.cuda
def test_cuda_fit_with_duplicates_maps_them_back(cuda):
    """A CUDA fit of rows that repeat: the hashes collide, numpy's row sort
    runs once, the fit sees the host's unique rows, and each duplicate gets
    its original's embedding row."""
    from torchdr_tpu_torch.ops.cuda.hash_kernel import deduplicate_fit_input, row_hash
    from torchdr_tpu_torch.utils.wrappers import deduplicate

    X = _clustered_with(100, 11)
    X_unique, inverse = deduplicate(X)
    launches, exact = row_hash.launches, deduplicate.exact_calls
    got, got_inv = deduplicate_fit_input(X, torch.from_numpy(X).to(cuda))
    assert row_hash.launches == launches + 1 and deduplicate.exact_calls == exact + 1
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), X_unique) and np.array_equal(got_inv, inverse)
    model = UMAP(random_state=0, max_iter=20)
    Z = model.fit_transform(X)
    assert model.n_samples_in_ == X_unique.shape[0] == X.shape[0] - 100
    assert np.array_equal(Z[-100:], Z[:100])


@pytest.mark.cuda
def test_a_forced_hash_collision_on_the_card_takes_the_exact_path(cuda, monkeypatch):
    """Every hash on the card the same: the fit's test takes numpy's row
    sort once, with ``deduplicate``'s result under the same collision on
    the host (rows that differ only in a zero's sign merge there)."""
    from torchdr_tpu_torch.ops.cuda import hash_kernel
    from torchdr_tpu_torch.utils import wrappers

    X = _clustered_with(0, 12)
    X[1] = 0.0
    X[2] = -0.0
    monkeypatch.setattr(hash_kernel, "row_hash",
                        lambda X_dev: torch.zeros(X_dev.shape[0], dtype=torch.int64,
                                                  device=X_dev.device))
    monkeypatch.setattr(wrappers, "_row_hashes",
                        lambda Xn: np.zeros(Xn.shape[0], dtype=np.uint64))
    X_unique, inverse = wrappers.deduplicate(X)
    exact = wrappers.deduplicate.exact_calls
    got, got_inv = hash_kernel.deduplicate_fit_input(X, torch.from_numpy(X).to(cuda))
    assert wrappers.deduplicate.exact_calls == exact + 1
    assert got.device.type == "cuda" and got.shape[0] == X.shape[0] - 1
    assert np.array_equal(got.cpu().numpy(), X_unique) and np.array_equal(got_inv, inverse)
    assert got_inv[1] == got_inv[2]
