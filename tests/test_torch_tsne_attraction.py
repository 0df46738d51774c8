"""t-SNE's and SNE's attraction over the kNN edges and their transpose
(``ops/attraction.py``, A1's plain version in ``ops/cuda/attraction_kernel.py``).

The transpose (each row's in-edges) is held to a dense transposition, the
out ∪ in formula (A1's plain version) in float64 to autograd's gradient of
the cross-entropy the estimators compute, and the CPU path of TSNE and SNE
to that cross-entropy bit for bit: A1 runs on the card only
(``tests/test_torch_cuda.py`` holds it to its plain version there).
"""

import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu_torch import SNE, TSNE
from torchdr_tpu_torch.ops.attraction import knn_attraction_loss, knn_transpose
from torchdr_tpu_torch.ops.cuda.attraction_kernel import tsne_attraction, tsne_attraction_plain
from torchdr_tpu_torch.ops.distance import pairwise_distances_indexed
from torchdr_tpu_torch.ops.reductions import cross_entropy_loss


def _graph(case, seed=0, dtype=np.float64):
    """(NN int32, P) without repeated ids in a row, P > 0 on every edge."""
    rng = np.random.default_rng(seed)
    n, k = {"pads": (40, 6), "no_in_edges": (30, 4), "hub": (1_100, 3), "n1_k1": (1, 1),
            "k1": (25, 1), "repeats": (30, 5)}[case]
    first = 10 if case == "no_in_edges" else 0  # rows 0..9 have no in-edge there
    if n == 1:
        NN = np.full((1, 1), -1)
    else:
        NN = np.stack([rng.choice(np.setdiff1d(np.arange(first, n), [i]), k, replace=False)
                       for i in range(n)])
    if case == "pads":
        NN[rng.random((n, k)) < 0.2] = -1
        NN[0] = -1  # a row of pads only
    elif case == "hub":
        NN[1:, 0] = 0  # row 0: in-degree n - 1
        NN[1:, 1:] = np.where(NN[1:, 1:] == 0, 1, NN[1:, 1:])
        NN[1, 1:] = [2, 3]
    elif case == "repeats":
        NN[3, 1] = NN[3, 0]  # a row that repeats an id: both edges are listed
    P = np.where(NN >= 0, rng.uniform(0.1, 1.0, (n, k)), 0.0).astype(dtype)
    return torch.from_numpy(NN.astype(np.int32)), torch.from_numpy(P)


@pytest.mark.parametrize("case", ["pads", "no_in_edges", "hub", "n1_k1", "k1", "repeats"])
def test_transpose_is_the_dense_transposition(case):
    """Row j lists, in row order, the rows i of its in-edges with P_ij, once
    per edge: the columns of the dense graph, pads left out."""
    NN, P = _graph(case)
    n, k = NN.shape
    in_ptr, in_src, in_P = knn_transpose(NN, P)
    assert (in_ptr.dtype, in_src.dtype, in_P.dtype) == (torch.int64, torch.int32, P.dtype)
    ptr = in_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(in_src) == len(in_P) == int((NN >= 0).sum())
    for j in range(n):
        # column j of the dense graph, edge by edge in row order
        rows, slots = np.nonzero(NN.numpy() == j)
        np.testing.assert_array_equal(in_src[ptr[j]:ptr[j + 1]].numpy(), rows)
        np.testing.assert_array_equal(in_P[ptr[j]:ptr[j + 1]].numpy(), P.numpy()[rows, slots])
    if case == "hub":
        assert ptr[1] - ptr[0] >= 1_000
    if case == "no_in_edges":
        assert np.all(np.diff(ptr)[:10] == 0)
    if case == "repeats":
        assert np.count_nonzero(in_src[ptr[NN[3, 0]]:ptr[NN[3, 0] + 1]].numpy() == 3) == 2


def _cross_entropy(Z, P, NN, kernel):
    """The estimators' attraction: the cross-entropy of P against log Q on
    the kNN edges, through the ``Z[NN]`` gather."""
    D = pairwise_distances_indexed(Z, key_indices=NN, metric="sqeuclidean")
    return cross_entropy_loss(P, -torch.log1p(D) if kernel == "student" else -D, log=True)


def _autograd(Z, P, NN, kernel):
    Zg = Z.detach().clone().requires_grad_(True)
    loss = _cross_entropy(Zg, P, NN, kernel)
    return torch.autograd.grad(loss, Zg)[0], loss.detach()


@pytest.mark.parametrize("case", ["pads", "hub", "repeats"])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_out_and_in_edges_give_autograds_gradient(kernel, d, case):
    """In float64 the gather over each row's out-edges and in-edges is
    autograd's gradient of the cross-entropy, and the rows' losses sum to it."""
    NN, P = _graph(case, seed=d)
    Z = torch.from_numpy(np.random.default_rng(d).normal(scale=2.0, size=(NN.shape[0], d)))
    want, want_loss = _autograd(Z, P, NN, kernel)
    grad, row_loss = tsne_attraction_plain(Z, NN, P, knn_transpose(NN, P), kernel)
    assert grad.dtype == torch.float64
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * max(1.0, float(want.abs().max())))
    np.testing.assert_allclose(float(row_loss.sum()), float(want_loss), rtol=1e-12)


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_a1_takes_cuda_tensors_only(kernel):
    """A1 has no CPU path: on a CPU tensor it raises and launches nothing,
    as does the autograd ``Function`` around it; the CPU fits run the
    cross-entropy of the gather instead."""
    NN, P = _graph("pads", seed=5, dtype=np.float32)
    Z = torch.zeros((NN.shape[0], 2), dtype=torch.float32, requires_grad=True)
    transpose = knn_transpose(NN, P)
    before = tsne_attraction.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tsne_attraction(Z.detach(), NN, P, transpose, kernel)
    with pytest.raises(ValueError, match="unsupported device"):
        knn_attraction_loss(Z, P, NN, transpose, kernel)
    assert tsne_attraction.launches == before


@pytest.mark.parametrize("cls, kernel", [(TSNE, "student"), (SNE, "gaussian")])
@pytest.mark.parametrize("with_transpose", [False, True])
def test_cpu_attractive_loss_is_the_cross_entropy_bit_for_bit(cls, kernel, with_transpose):
    """On the CPU ``_attractive_loss`` and its gradient are the cross-entropy
    of the ``Z[NN]`` gather, bit for bit, also where the constants hold the
    transpose (as a fit's on the card do): A1 takes float32 CUDA tensors
    only."""
    NN, P = _graph("pads", seed=7, dtype=np.float32)
    Z = torch.from_numpy(np.random.default_rng(7).normal(size=(NN.shape[0], 2)).astype(np.float32))
    consts = {"P": P, "NN": NN, "n": NN.shape[0]}
    if with_transpose:
        consts.update(zip(("in_ptr", "in_src", "in_P"), knn_transpose(NN, P)))
    model = cls(device="cpu")
    before = tsne_attraction.launches
    Zg = Z.clone().requires_grad_(True)
    loss, _ = model._attractive_loss(Zg, consts, {}, 0)
    grad = torch.autograd.grad(loss, Zg)[0]
    want_grad, want_loss = _autograd(Z, P, NN, kernel)
    assert torch.equal(loss.detach(), want_loss) and torch.equal(grad, want_grad)
    assert tsne_attraction.launches == before


@pytest.mark.parametrize("cls", [TSNE, SNE])
def test_cpu_fit_builds_no_transpose_and_launches_nothing(cls):
    """A fit on the CPU keeps the loop's constants as they were (no
    transpose) and never launches A1."""
    seen = {}

    class Watched(cls):
        def _build_consts(self, X):
            seen["consts"] = super()._build_consts(X)
            return seen["consts"]

    X = np.random.default_rng(3).normal(size=(60, 5)).astype(np.float32)
    tsne_attraction.launches = 0
    kw = {"lr": 5.0} if cls is SNE else {}
    Z = Watched(perplexity=5, max_iter=20, random_state=0, device="cpu", **kw).fit_transform(X)
    assert np.all(np.isfinite(Z))
    assert set(seen["consts"]) == {"P", "NN", "n"}
    assert tsne_attraction.launches == 0
