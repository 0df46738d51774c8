"""kNN-based evaluation metrics (counterpart of ``torchdr_tpu/eval/knn_metrics.py``).

Each runs on the exact kNN graph of ``ops/distance.py`` on ``device``
("auto": the card, raising without one; with ``mesh=``, the mesh's first
device). With a device mesh the kNN build row-shards the queries over it
(``parallel/knn.knn_graph_sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import resolve_device
from ..ops.distance import knn_graph
from ..parallel.knn import knn_graph_sharded
from ..parallel.mesh import check_mesh
from ..utils.wrappers import full_float32, to_torch


def _knn_indices(X, k, metric, exclude_diag, mesh):
    if mesh is not None:
        _, idx = knn_graph_sharded(X, k, mesh, metric=metric, exclude_diag=exclude_diag)
    else:
        _, idx = knn_graph(X, k=k, metric=metric, exclude_diag=exclude_diag)
    return idx.long()


def _as_index_tensor(a, device) -> torch.Tensor:
    """Labels or ids (tensor, numpy or anything ``np.asarray`` reads) on ``device``."""
    return (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))).to(device)


def _overlap(idx_a: torch.Tensor, idx_b: torch.Tensor) -> torch.Tensor:
    """Per row, how many of ``idx_a``'s ids are in ``idx_b``'s row."""
    return torch.any(idx_a[:, :, None] == idx_b[:, None, :], dim=2).sum(dim=1)


@full_float32()
def knn_label_accuracy(
    X,
    labels,
    k: int = 10,
    metric: str = "euclidean",
    exclude_self: bool = True,
    return_per_sample: bool = False,
    mesh=None,
    device: str = "auto",
):
    """Fraction of each point's k nearest neighbours sharing its label."""
    X, _ = to_torch(X, device=resolve_device(device, check_mesh(mesh)))
    labels = _as_index_tensor(labels, X.device)
    idx = _knn_indices(X, k, metric, exclude_self, mesh)
    per_sample = torch.mean((labels[idx] == labels[:, None]).to(torch.float32), dim=1)
    return per_sample if return_per_sample else float(torch.mean(per_sample))


@full_float32()
def neighborhood_preservation(
    X,
    Z,
    K: int,
    metric: str = "euclidean",
    return_per_sample: bool = False,
    mesh=None,
    device: str = "auto",
):
    """K-ary neighbourhood overlap between the input X and the embedding Z:
    |kNN_X ∩ kNN_Z| / K for each point."""
    dev = resolve_device(device, check_mesh(mesh))
    X, _ = to_torch(X, device=dev)
    Z, _ = to_torch(Z, device=dev)
    idx_X = _knn_indices(X, K, metric, True, mesh)
    idx_Z = _knn_indices(Z, K, metric, True, mesh)
    per_sample = _overlap(idx_Z, idx_X).to(torch.float32) / K
    return per_sample if return_per_sample else float(torch.mean(per_sample))


@full_float32()
def neighborhood_preservation_sampled(
    X,
    Z,
    K: int,
    n_queries: int = 2048,
    seed: int = 0,
    metric: str = "euclidean",
    device: str = "auto",
):
    """K-ary neighbourhood preservation of ``n_queries`` rows (a seeded
    numpy draw, as in the JAX package) against all n rows in both spaces:
    the large-n form, two (q, n) products instead of an (n, n) graph."""
    dev = resolve_device(device)
    X, _ = to_torch(X, device=dev)
    Z, _ = to_torch(Z, device=dev)
    n = X.shape[0]
    q = min(n_queries, n)
    rng = np.random.default_rng(seed)
    sel = torch.from_numpy(np.sort(rng.choice(n, q, replace=False))).to(dev)

    def sampled_knn(A):
        _, idx = knn_graph(A[sel], A, k=K + 1, metric=metric, exclude_diag=False)
        idx = idx.long()
        # move each row's own id to the end, keep K columns
        order = torch.argsort((idx == sel[:, None]).to(torch.int32), dim=1, stable=True)
        return torch.gather(idx, 1, order)[:, :K]

    member = _overlap(sampled_knn(Z), sampled_knn(X))
    return float(torch.mean(member.to(torch.float32) / K))


@full_float32()
def knn_recall(indices_pred, indices_true, return_per_sample: bool = False,
               device: str = "auto"):
    """Recall@k of a predicted kNN index set against the true one."""
    dev = resolve_device(device)
    pred = _as_index_tensor(indices_pred, dev)
    true = _as_index_tensor(indices_true, dev)
    member = torch.any(pred[:, :, None] == true[:, None, :], dim=2)
    per_sample = torch.mean(member.to(torch.float32), dim=1)
    return per_sample if return_per_sample else float(torch.mean(per_sample))
