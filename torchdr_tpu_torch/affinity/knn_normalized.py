"""Affinities normalized by nearest-neighbor distances.

Counterpart of ``torchdr_tpu/affinity/knn_normalized.py``; the port
carries :class:`UMAPAffinity` (fuzzy simplicial set) with its calibration,
and :class:`PACMAPAffinity` (PACMAP's neighbour selection). The
self-tuning, MAGIC and PHATE affinities wait for a later slice.
"""

from __future__ import annotations

import torch

from ..ops.root_search import binary_search
from ..ops.sparse import symmetrize_sparse
from ..utils.validation import check_neighbor_param
from .base import SparseAffinity


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
