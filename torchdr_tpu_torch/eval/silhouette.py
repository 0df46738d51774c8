"""Silhouette score and samples (counterpart of ``torchdr_tpu/eval/silhouette.py``).

One pairwise-distance pass in row blocks: each block's distances times the
(weighted) one-hot matrix of the labels gives every point's summed distance
to every cluster, so the (n, n) matrix is never held whole.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import resolve_device
from ..ops.metrics import pairwise_block
from ..utils.wrappers import full_float32, to_torch
from .knn_metrics import _as_index_tensor


def _silhouette_samples(X, labels, weights, metric: str, n_clusters: int,
                        block_size: int = 4096):
    n = X.shape[0]
    ids = torch.arange(n_clusters, device=X.device)
    onehot = (labels[None, :] == ids[:, None]).to(X.dtype)  # (c, n)
    w = weights if weights is not None else torch.ones((n,), dtype=X.dtype, device=X.device)
    wc = onehot * w[None, :]
    cluster_mass = torch.sum(wc, dim=1)  # (c,)
    dist_to_cluster = torch.cat([
        pairwise_block(X[r0 : r0 + block_size], X, metric) @ wc.T
        for r0 in range(0, n, block_size)
    ])
    own_mass = cluster_mass[labels]
    # the own distance is 0 but the own weight counts in the cluster's mass
    intra_denom = torch.clamp(own_mass - w, min=1e-12)
    a = dist_to_cluster[torch.arange(n, device=X.device), labels] / intra_denom
    mean_other = dist_to_cluster / torch.clamp(cluster_mass[None, :], min=1e-12)
    mean_other = torch.where(ids[None, :] == labels[:, None],
                             torch.full_like(mean_other, float("inf")), mean_other)
    b = torch.min(mean_other, dim=1).values
    sil = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    # a point alone in its cluster scores 0
    return torch.where(own_mass - w <= 0, torch.zeros_like(sil), sil)


@full_float32()
def silhouette_samples(
    X, labels, weights=None, metric: str = "sqeuclidean", device: str = "auto"
):
    """Per-sample silhouette coefficients, on ``device`` ("auto": the card)."""
    X, _ = to_torch(X, device=resolve_device(device))
    labels = _as_index_tensor(labels, X.device)
    uniq, inv = torch.unique(labels, return_inverse=True)
    if int(uniq.shape[0]) < 2:
        raise ValueError(
            "[TorchDR-Torch] ERROR : silhouette requires at least 2 labels "
            f"(got {int(uniq.shape[0])})."
        )
    w = None if weights is None else to_torch(weights, device=X.device)[0]
    return _silhouette_samples(X, inv.reshape(-1), w, metric, int(uniq.shape[0]))


@full_float32()
def silhouette_score(
    X,
    labels,
    weights=None,
    metric: str = "sqeuclidean",
    device: str = "auto",
    sample_size: Optional[int] = None,
    random_state: Optional[int] = None,
):
    """Mean silhouette coefficient, optionally on ``sample_size`` rows drawn
    without replacement by a ``torch.Generator`` seeded with
    ``random_state`` (or 0)."""
    X, _ = to_torch(X, device=resolve_device(device))
    labels = _as_index_tensor(labels, X.device)
    if sample_size is not None and sample_size < X.shape[0]:
        g = torch.Generator()
        g.manual_seed(int(random_state or 0))
        idx = torch.randperm(X.shape[0], generator=g)[:sample_size].to(X.device)
        X, labels = X[idx], labels[idx]
        if weights is not None:
            weights = to_torch(weights, device=X.device)[0][idx]
    return float(torch.mean(silhouette_samples(X, labels, weights, metric, device=X.device)))
