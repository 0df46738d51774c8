"""k-means and the adjusted Rand index (counterpart of ``torchdr_tpu/eval/kmeans_ari.py``).

The index is computed in numpy from the contingency table; the clustering
is the port's :func:`~torchdr_tpu_torch.ops.kmeans.kmeans_fit` on
``device`` ("auto": the card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..base import resolve_device
from ..ops.kmeans import kmeans_fit
from ..utils.wrappers import to_torch


def adjusted_rand_index(labels_true, labels_pred) -> float:
    """ARI from the contingency table (Hubert & Arabie 1985)."""
    lt = np.asarray(labels_true)
    lp = np.asarray(labels_pred)
    _, ti = np.unique(lt, return_inverse=True)
    _, pi = np.unique(lp, return_inverse=True)
    n = lt.shape[0]
    C = np.zeros((ti.max() + 1, pi.max() + 1), np.int64)
    np.add.at(C, (ti, pi), 1)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_comb = comb2(C).sum()
    sum_a = comb2(C.sum(axis=1)).sum()
    sum_b = comb2(C.sum(axis=0)).sum()
    expected = sum_a * sum_b / comb2(n)
    max_index = 0.5 * (sum_a + sum_b)
    denom = max_index - expected
    if denom == 0:
        return 1.0
    return float((sum_comb - expected) / denom)


def kmeans_ari(
    X,
    labels,
    n_clusters: Optional[int] = None,
    max_iter: int = 100,
    random_state: Optional[int] = None,
    n_init: int = 3,
    init_centers: Optional[Sequence] = None,
    device: str = "auto",
):
    """Cluster X with k-means and score the agreement with ``labels`` by
    the ARI. Returns ``(ari, predicted_labels)``, the labels of the restart
    of least inertia among ``n_init``. The seeding draws come from one
    ``torch.Generator`` seeded with ``random_state`` (or 0);
    ``init_centers`` (one (n_clusters, d) array per restart) takes given
    seedings instead."""
    X, _ = to_torch(X, device=resolve_device(device))
    labels_np = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    if n_clusters is None:
        n_clusters = int(np.unique(labels_np).shape[0])
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(random_state or 0))

    best = None
    for i in range(n_init):
        c0 = None if init_centers is None else init_centers[i]
        _, pred, inertia = kmeans_fit(X, n_clusters, gen, max_iter=max_iter, init_centers=c0)
        inertia = float(inertia)
        if best is None or inertia < best[0]:
            best = (inertia, pred)
    pred = best[1].cpu().numpy()
    return adjusted_rand_index(labels_np, pred), pred
