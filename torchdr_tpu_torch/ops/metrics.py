"""Distance metrics on tensors (counterpart of ``torchdr_tpu/ops/metrics.py``).

Dense squared-euclidean forms are one matrix product plus rank-1 norm
corrections. Every gram runs in full float32, because a reduced-precision
cross term flips neighbour ranks: the public entry points that reach it
hold cuBLAS there (``utils.wrappers.full_float32``).
"""

from __future__ import annotations

import torch

LIST_METRICS = ["euclidean", "sqeuclidean", "manhattan", "angular", "sqhyperbolic"]

# Distance used to mask out self/invalid entries when selecting neighbors.
MASK_VALUE = 1e12


def check_metric(metric: str) -> None:
    if metric not in LIST_METRICS:
        raise ValueError(f"[TorchDR-Torch] ERROR : The '{metric}' distance is not supported.")


def _gram(X: torch.Tensor, Y: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """X @ Y.T in full float32.

    ``precision`` is accepted for parity with the JAX package, whose
    "high"/"default" select reduced-precision MXU passes; the port always
    computes the exact float32 product.
    """
    return torch.matmul(X, Y.T)


def sq_dists_from_gram(x_norm, y_norm, gram):
    """Squared euclidean distances from precomputed norms and gram block."""
    return torch.clamp(x_norm[:, None] + y_norm[None, :] - 2.0 * gram, min=0.0)


def pairwise_block(
    X: torch.Tensor, Y: torch.Tensor, metric: str = "sqeuclidean", precision: str = "highest"
) -> torch.Tensor:
    """Dense pairwise distances between two blocks.

    sqeuclidean / euclidean via norms + gram, manhattan via broadcast,
    angular = -<x, y>, sqhyperbolic = arccosh(1 + 2 d² / ((1-|x|²)(1-|y|²)))².
    """
    check_metric(metric)
    if metric == "manhattan":
        return torch.cdist(X, Y, p=1)
    if metric == "angular":
        return -_gram(X, Y, precision)
    x_norm = torch.sum(X * X, dim=-1)
    y_norm = torch.sum(Y * Y, dim=-1)
    sq = sq_dists_from_gram(x_norm, y_norm, _gram(X, Y, precision))
    if metric == "sqeuclidean":
        return sq
    if metric == "euclidean":
        return torch.sqrt(sq)
    denom = (1.0 - x_norm)[:, None] * (1.0 - y_norm)[None, :]
    return acosh_above_one(1.0 + 2.0 * (sq / denom)) ** 2


def acosh_above_one(x: torch.Tensor) -> torch.Tensor:
    """arccosh(max(x, 1 + 1e-7)): finite at zero distance (arccosh'(1) = ∞)
    with no gradient below the floor; ``torch.maximum`` splits the gradient
    at a tie, as the JAX package's ``jnp.maximum`` does."""
    return torch.acosh(torch.maximum(x, x.new_full((), 1.0 + 1e-7)))


def indexed_block(Xq: torch.Tensor, Yk: torch.Tensor, metric: str = "sqeuclidean") -> torch.Tensor:
    """Distances between queries ``Xq (n, d)`` and per-query keys ``Yk (n, k, d)``."""
    check_metric(metric)
    diff = Xq[:, None, :] - Yk
    if metric == "manhattan":
        return torch.sum(torch.abs(diff), dim=-1)
    if metric == "angular":
        return -torch.sum(Xq[:, None, :] * Yk, dim=-1)
    sq = torch.sum(diff * diff, dim=-1)
    if metric == "sqeuclidean":
        return sq
    if metric == "euclidean":
        return torch.sqrt(sq)
    x_norm = torch.sum(Xq * Xq, dim=-1)[:, None]
    y_norm = torch.sum(Yk * Yk, dim=-1)
    denom = (1.0 - x_norm) * (1.0 - y_norm)
    return acosh_above_one(1.0 + 2.0 * (torch.clamp(sq, min=0.0) / denom)) ** 2
