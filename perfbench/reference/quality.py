"""Recall of a neighbour graph and trustworthiness of an embedding.

``recall`` is a frozen copy of ``torchdr_tpu_torch/benchmarks/ivf_recall.recall``
and ``trustworthiness`` of ``torchdr_tpu_torch/benchmarks/real_digits.trustworthiness``
(``perfbench/tests/test_perfbench_copies.py`` holds each equal to its
original); neither imports the program.
"""

from __future__ import annotations

import numpy as np
import torch


def recall(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row, the share of ``want``'s ids that ``got`` holds."""
    return (want[:, :, None].long() == got[:, None, :].long()).any(-1).float().mean(1)


def trustworthiness(X, Z, k: int = 15, device="cpu") -> float:
    """scikit-learn's ``trustworthiness(X, Z, n_neighbors=k)`` on ``device``:
    each point's k nearest embedded neighbours are ranked in its input-space
    order (itself excluded, ties in either space by a stable sort, so that
    Z = X reads 1), and the ranks' excess over k, summed, is scaled by
    2 / (n k (2n - 3k - 1)). Distances in float64 from the differences (no
    gram), so integer pixels tie exactly."""
    X = torch.as_tensor(np.asarray(X), dtype=torch.float64, device=device)
    Z = torch.as_tensor(np.asarray(Z), dtype=torch.float64, device=device)
    n = X.shape[0]
    mode = "donot_use_mm_for_euclid_dist"
    dX = torch.cdist(X, X, compute_mode=mode).fill_diagonal_(float("inf"))
    order = torch.argsort(dX, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(1, n + 1, device=X.device).expand(n, n))
    dZ = torch.cdist(Z, Z, compute_mode=mode).fill_diagonal_(float("inf"))
    nbrs = torch.argsort(dZ, dim=1, stable=True)[:, :k]
    excess = (torch.gather(rank, 1, nbrs) - k).clamp(min=0).sum()
    return 1.0 - float(excess) * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
