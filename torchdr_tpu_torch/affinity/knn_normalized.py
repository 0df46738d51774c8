"""Affinities normalized by nearest-neighbor distances.

Counterpart of ``torchdr_tpu/affinity/knn_normalized.py``: the dense
self-tuning, MAGIC and PHATE affinities, :class:`UMAPAffinity` (fuzzy
simplicial set) with its calibration, and :class:`PACMAPAffinity`
(PACMAP's neighbour selection).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..ops.distance import pairwise_distances
from ..ops.reductions import matrix_power
from ..ops.root_search import binary_search
from ..ops.sparse import symmetrize_sparse
from ..parallel.sparse import distributed_symmetrize_sparse
from ..utils.validation import check_neighbor_param
from .base import Affinity, LogAffinity, SparseAffinity


def _kth_smallest(C: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest entry of each row (the diagonal included)."""
    return torch.topk(C, k, dim=1, largest=False, sorted=True).values[:, -1]


class SelfTuningAffinity(LogAffinity):
    r"""Self-tuning affinity (Zelnik-Manor & Perona 2004):
    exp(-C_ij / (σ_i σ_j)) with σ_i the K-th smallest distance of row i,
    optionally normalized along ``normalization_dim``."""

    def __init__(
        self,
        K: int = 7,
        normalization_dim: Union[int, Tuple[int, ...], None] = (0, 1),
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        **kwargs,
    ):
        super().__init__(
            metric=metric, zero_diag=zero_diag, device=device, verbose=verbose, **kwargs
        )
        self.K = K
        self.normalization_dim = normalization_dim

    def _compute_log_affinity(self, X: torch.Tensor):
        C = self._distance_matrix(X)
        kth = _kth_smallest(C, self.K)
        self.sigma_ = kth
        log_aff = -C / (kth[:, None] * kth[None, :])
        if self.normalization_dim is not None:
            log_aff = log_aff - torch.logsumexp(
                log_aff, dim=self.normalization_dim, keepdim=True
            )
        return log_aff


class MAGICAffinity(Affinity):
    r"""MAGIC affinity (van Dijk et al. 2018): exp(-C/σ_i), symmetrized by
    the mean, then row-normalized (a diffusion operator, not symmetric)."""

    def __init__(
        self,
        K: int = 7,
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        **kwargs,
    ):
        super().__init__(
            metric=metric, zero_diag=zero_diag, device=device, verbose=verbose, **kwargs
        )
        self.K = K

    def _compute_affinity(self, X: torch.Tensor):
        C = self._distance_matrix(X)
        kth = _kth_smallest(C, self.K)
        self.sigma_ = kth
        P = torch.exp(-C / kth[:, None])
        P = 0.5 * (P + P.T)
        return P / torch.sum(P, dim=1, keepdim=True)


class PHATEAffinity(Affinity):
    r"""PHATE potential affinity (Moon et al. 2019).

    α-decay kernel, symmetrized and row-normalized, diffused t steps
    (:func:`matrix_power`), then the negative Euclidean distances between
    the rows of the potential -log P. The potential is kept in float32, as
    in the JAX package: each column is centred before the distances, which
    removes the common mode that would cancel in the norms-plus-gram form.
    """

    def __init__(
        self,
        metric: str = "euclidean",
        device: str = "auto",
        verbose: bool = False,
        k: int = 5,
        alpha: float = 10.0,
        t: int = 5,
        **kwargs,
    ):
        super().__init__(
            metric=metric, zero_diag=False, device=device, verbose=verbose, **kwargs
        )
        self.k = k
        self.alpha = alpha
        self.t = t

    def _compute_affinity(self, X: torch.Tensor):
        C = self._distance_matrix(X)
        kth = _kth_smallest(C, self.k)
        self.sigma_ = kth
        P = torch.exp(-((C / kth[:, None]) ** self.alpha))
        P = 0.5 * (P + P.T)
        P = P / torch.sum(P, dim=1, keepdim=True)
        P = matrix_power(P, self.t)
        logP = -torch.log(torch.clamp(P, min=1e-12))
        logP = logP - torch.mean(logP, dim=0, keepdim=True)
        D, _ = pairwise_distances(logP, metric="euclidean")
        return -D


class UMAPAffinity(SparseAffinity):
    r"""UMAP fuzzy simplicial set affinity (McInnes et al. 2018).

    Bisection on σ_i s.t. Σ_j exp(-(C_ij - ρ_i)/σ_i) = log2(n_neighbors)
    with ρ_i the min distance, then fuzzy union P + Pᵀ - P∘Pᵀ.
    """

    def __init__(
        self,
        n_neighbors: float = 30,
        max_iter: int = 1000,
        sparsity: bool = True,
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        symmetrize: bool = True,
        max_degree: int | None = None,
        **kwargs,
    ):
        super().__init__(
            metric=metric,
            zero_diag=zero_diag,
            device=device,
            verbose=verbose,
            sparsity=sparsity,
            **kwargs,
        )
        self.n_neighbors = n_neighbors
        self.max_iter = max_iter
        self.symmetrize = symmetrize
        # Cap on the fuzzy-union width: keeps the STRONGEST edges per row
        # (value-priority packing in symmetrize_sparse).
        self.max_degree = max_degree

    def _compute_sparse_affinity(self, X, return_indices: bool = True, **kwargs):
        n = X.shape[0]
        n_neighbors = check_neighbor_param(int(self.n_neighbors), n, logger=self.logger)

        if self.sparsity:
            self.logger.info(f"Sparsity mode: computing {n_neighbors} nearest neighbors.")
            C, indices = self._distance_matrix(X, k=n_neighbors, return_indices=True)
        else:
            C, indices = self._distance_matrix(X, return_indices=True)

        P, rho, eps = _umap_calibrate(C, float(n_neighbors), int(self.max_iter))
        self.rho_ = rho
        self.eps_ = eps

        if self.symmetrize:
            if self.sparsity:
                k_out = None
                if self.max_degree is not None:
                    k_out = max(8, -(-int(self.max_degree) // 8) * 8)
                mesh = self._active_mesh()
                if mesh is not None:
                    # the edge exchange over the mesh: each shard merges the
                    # transposed edges of the rows it owns
                    P, indices = distributed_symmetrize_sparse(
                        P, indices, mesh, mode="sum_minus_prod", k_out=k_out
                    )
                else:
                    P, indices = symmetrize_sparse(P, indices, mode="sum_minus_prod", k_out=k_out)
            else:
                P = P + P.T - P * P.T

        return (P, indices) if return_indices else P


def _umap_calibrate(C: torch.Tensor, n_neighbors: float, max_iter: int):
    """Row-wise bisection for the UMAP bandwidth; returns (P, rho, eps)."""
    n = C.shape[0]
    rho = torch.min(C, dim=1).values
    target = torch.log2(torch.tensor(n_neighbors, dtype=C.dtype)).item()
    shifted = C - rho[:, None]

    def marginal_gap(eps):
        log_marg = torch.logsumexp(-shifted / eps[:, None], dim=1)
        return torch.exp(log_marg) - target

    eps = binary_search(marginal_gap, n, max_iter=max_iter, dtype=C.dtype, device=C.device)
    P = torch.exp(-shifted / eps[:, None])
    return P, rho, eps


def _smallest(C: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row, ascending, equal
    values by index as ``lax.top_k`` orders them."""
    return torch.sort(C, dim=1, stable=True).indices[:, :k]


class PACMAPAffinity(SparseAffinity):
    r"""PACMAP neighbour selection (Wang et al. 2021).

    kNN with k = n_neighbors + 50, distances scaled by ρ_i ρ_j (ρ the mean
    of the 4th-6th NN distances), then the n_neighbors smallest scaled
    distances. Returns indices only: ``(None, indices)``.
    """

    def __init__(
        self,
        n_neighbors: int = 10,
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        **kwargs,
    ):
        super().__init__(
            metric=metric,
            zero_diag=zero_diag,
            device=device,
            verbose=verbose,
            sparsity=True,
            **kwargs,
        )
        self.n_neighbors = n_neighbors

    def _compute_sparse_affinity(self, X, return_indices: bool = True, **kwargs):
        n = X.shape[0]
        k = check_neighbor_param(min(self.n_neighbors + 50, n - 1), n, logger=self.logger)
        C, temp_indices = self._distance_matrix(X, k=k, return_indices=True)

        sq_nn = torch.gather(C, 1, _smallest(C, min(6, k)))
        rho = torch.mean(torch.sqrt(sq_nn)[:, 3:6], dim=1)
        self.rho_ = rho

        scaled = C / (rho[:, None] * rho[temp_indices.long()])
        local = _smallest(scaled, self.n_neighbors)
        final_indices = torch.gather(temp_indices, 1, local)

        if return_indices:
            return None, final_indices
        return scaled
