"""The plain reference on the CPU at small sizes: against scikit-learn where
it has the function, else against float64 brute force or autograd."""

import math

import numpy as np
import pytest
import torch

from perfbench.data.clustered import make_clustered
from perfbench.reference import affinity as aff
from perfbench.reference import gradient as grad
from perfbench.reference.knn import all_neighbours, neighbours_of_rows
from perfbench.reference.precision import CONTROL, tf32_round
from perfbench.reference.quality import recall, trustworthiness


def _rows(n=300, d=20, seed=0):
    X, _ = make_clustered(n, d, 5, seed=seed)
    return torch.from_numpy(X)


def _brute_knn(X, k):
    D = ((X.double()[:, None, :] - X.double()[None, :, :]) ** 2).sum(-1)
    D.fill_diagonal_(float("inf"))
    return torch.topk(D, k, largest=False).indices


@pytest.mark.parametrize("k", [1, 7, 30])
def test_neighbours_match_scikit_learn(k):
    from sklearn.neighbors import NearestNeighbors

    X = _rows()
    want = NearestNeighbors(n_neighbors=k + 1, algorithm="brute").fit(X.double()).kneighbors(
        X.double(), return_distance=False)[:, 1:]
    rows = torch.arange(0, 300, 3)
    _, got_rows = neighbours_of_rows(X, rows, k, block=16)
    _, got_all = all_neighbours(X, k, block=64)
    assert torch.equal(got_rows, torch.from_numpy(want[rows.numpy()]))
    assert torch.equal(got_all, torch.from_numpy(want))


def test_control_neighbours_are_a_tf32_gram():
    X = _rows(400, 64)
    _, ids = all_neighbours(X, 10, CONTROL)
    assert ids.shape == (400, 10)
    assert not (ids == torch.arange(400)[:, None]).any()
    assert float(recall(ids, _brute_knn(X, 10)).mean()) > 0.5


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.randn(10_000) * 100
    r = tf32_round(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(tf32_round(r), r)


def test_umap_memberships_calibrate_each_row():
    D, _ = all_neighbours(_rows(), 15)
    A = aff.umap_memberships(D, 15)
    assert torch.allclose(A.sum(1), torch.full((300,), math.log2(15), dtype=A.dtype), atol=1e-12)
    assert torch.equal(A[:, 0], torch.ones(300, dtype=A.dtype))


def test_fuzzy_union_is_the_dense_union():
    X = _rows(200)
    D, ids = all_neighbours(X, 10)
    A = aff.umap_memberships(D, 10)
    dense = torch.zeros(200, 200, dtype=torch.float64)
    dense.scatter_(1, ids, A)
    want = dense + dense.T - dense * dense.T
    keys, P = aff.fuzzy_union(A, ids, 200)
    got = torch.zeros(200 * 200, dtype=torch.float64)
    got[keys] = P
    assert torch.allclose(got.view(200, 200), want, atol=1e-15)
    keys8, P8 = aff.fuzzy_union(A, ids, 8)
    for i in (0, 17, 199):
        row = want[i][want[i] > 0]
        mine = P8[(keys8 // 200) == i]
        assert torch.allclose(mine.sort(descending=True).values,
                              row.sort(descending=True).values[:8])


def test_entropic_rows_match_scikit_learn():
    from sklearn.manifold._utils import _binary_search_perplexity

    D, _ = all_neighbours(_rows(), 90)
    P = aff.entropic_rows(D, 30.0)
    want = _binary_search_perplexity(D.numpy().astype(np.float32), 30.0, 0)
    assert torch.allclose(P * 300, torch.from_numpy(want).double(), atol=1e-4)
    H = -(P * 300 * torch.log(P * 300)).sum(1)
    assert torch.allclose(H, torch.full_like(H, math.log(30.0)), atol=1e-10)


def test_row_gaps_count_missing_columns():
    n = 10
    ref_keys = torch.tensor([0 * n + 1, 0 * n + 2, 3 * n + 4])
    ref_vals = torch.tensor([1.0, 0.5, 0.2], dtype=torch.float64)
    rows = torch.tensor([0, 3])
    got = aff.padded_rows(n, rows, torch.tensor([[1, -1], [4, 5]]),
                          torch.tensor([[0.9, 0.0], [0.2, 0.1]]))
    gaps = aff.row_gaps(n, rows, got, ref_keys, ref_vals)
    assert torch.allclose(gaps, torch.tensor([0.5, 0.1 / 0.2], dtype=torch.float64))


def test_umap_ab_is_the_published_fit():
    a, b = grad.umap_ab(1.0, 0.1)
    assert a == pytest.approx(1.577, abs=2e-3) and b == pytest.approx(0.895, abs=2e-3)


def test_umap_step_is_its_loop():
    g = torch.Generator().manual_seed(0)
    n, W, S = 40, 6, 9
    Z = torch.randn(n, 2, generator=g, dtype=torch.float64) * 3
    nn = torch.randint(0, n, (n, W), generator=g)
    fired = torch.randint(0, 3, (n, W), generator=g).double()
    neg = torch.randint(0, n, (S,), generator=g)
    a, b, rate, eps = 1.6, 0.9, 5.0, 1e-3
    got = grad.umap_step(Z, nn, fired, neg, a, b, rate, eps, block=7)
    for i in range(n):
        attr = np.zeros(2)
        for w in range(W):
            diff = (Z[i] - Z[nn[i, w]]).numpy()
            d2 = float(diff @ diff)
            if d2 > 0:
                attr += 2 * a * b * d2 ** (b - 1) / (1 + a * d2 ** b) * fired[i, w].item() * diff
        rep = np.zeros(2)
        for s in neg.tolist():
            if s != i:
                diff = (Z[i] - Z[s]).numpy()
                d2 = float(diff @ diff)
                rep += -2 * b / ((d2 + eps) * (1 + a * d2 ** b)) * diff
        rep *= fired[i].sum().item() * rate / S
        want = np.clip(attr, -4, 4) + np.clip(rep, -4, 4)
        assert np.allclose(got[i].numpy(), want, rtol=1e-12, atol=1e-14)


def test_tsne_step_is_autograd_of_the_loss():
    g = torch.Generator().manual_seed(1)
    n, k = 50, 6
    Z = torch.randn(n, 2, generator=g, dtype=torch.float64) * 2
    ids = torch.randint(0, n, (n, k), generator=g)
    ids[3, 2] = -1
    P = torch.rand(n, k, generator=g, dtype=torch.float64) / n
    ee = 4.0
    Zg = Z.clone().requires_grad_(True)
    diff = Zg[:, None, :] - Zg[ids.clamp(min=0)]
    attr = (torch.where(ids >= 0, P, 0) * torch.log1p((diff ** 2).sum(-1))).sum()
    q = 1.0 / (1.0 + torch.cdist(Zg, Zg) ** 2)
    rep = torch.log(q.sum() - q.diagonal().sum())
    (want,) = torch.autograd.grad(ee * attr + rep, Zg)
    assert torch.allclose(grad.tsne_step(Z, P, ids, ee, block=7), want, rtol=1e-10, atol=1e-12)


def test_trustworthiness_matches_scikit_learn():
    from sklearn.manifold import trustworthiness as sk_trust

    X = _rows(250, 30).numpy()
    Z = X[:, :2] + 0.3 * np.random.default_rng(0).standard_normal((250, 2)).astype(np.float32)
    assert trustworthiness(X, Z, 15) == pytest.approx(sk_trust(X, Z, n_neighbors=15), abs=1e-12)
