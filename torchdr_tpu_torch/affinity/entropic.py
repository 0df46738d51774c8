"""Affinities with entropic constraints.

Counterpart of ``torchdr_tpu/affinity/entropic.py``; this slice carries
the directed :class:`EntropicAffinity` (t-SNE's and SNE's input affinity)
and its solver, a batched bisection on each row's bandwidth through
``ops/root_search.binary_search``. ``SymmetricEntropicAffinity``, the
Sinkhorn affinity and the ``Normalized*`` affinities wait for the
TSNEkhorn slice.
"""

from __future__ import annotations

import torch

from ..ops.reductions import entropy as entropy_red
from ..ops.root_search import binary_search
from ..utils.validation import check_neighbor_param
from .base import SparseLogAffinity


def _log_Pe(C: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Unnormalized Gaussian log-kernel with per-row bandwidth."""
    return -C / eps[:, None]


def _bounds_entropic_affinity(C: torch.Tensor, perplexity: float):
    """Bracket bounds on eps from Vladymyrov & Carreira-Perpiñán (2013)."""
    n = C.shape[0]
    tN = torch.tensor(float(n), dtype=C.dtype, device=C.device)
    perp = torch.tensor(perplexity, dtype=C.dtype, device=C.device)
    max_val = torch.minimum(torch.sqrt(2.0 * tN), perp)

    def find_p1(x):
        return torch.log(max_val) - 2.0 * (1.0 - x) * torch.log(tN / (2.0 * (1.0 - x)))

    begin = torch.tensor([0.75], dtype=C.dtype, device=C.device)
    end = torch.tensor([1 - 1e-6], dtype=C.dtype, device=C.device)
    p1 = binary_search(find_p1, 1, begin=begin, end=end, max_iter=1000,
                       dtype=C.dtype, device=C.device)[0]

    dN = torch.max(C, dim=1).values
    d12 = torch.topk(C, 2, dim=1, largest=False, sorted=True).values
    d1, d2 = d12[:, 0], d12[:, 1]
    Delta_N = dN - d1
    Delta_2 = d2 - d1

    log_ratio = torch.log(tN / perp)
    beta_L = torch.maximum(
        (tN * log_ratio) / ((tN - 1.0) * Delta_N),
        torch.sqrt(log_ratio / (dN**2 - d1**2)),
    )
    beta_U = torch.log((tN - 1.0) * p1 / (1.0 - p1)) / Delta_2
    return 1.0 / beta_U, 1.0 / beta_L


def solve_entropic_affinity(
    C: torch.Tensor, perplexity: float, max_iter: int = 1000, use_bounds: bool = True
):
    """Per-row bisection on eps so that each row's entropy is
    log(perplexity) + 1.

    Returns ``(log_P, eps)``; ``log_P`` is row-normalized, then shifted by
    ``-log n`` so that the total mass is 1.
    """
    n = C.shape[0]
    # log(perp) + 1 in the input's type, as the reference forms it
    target_entropy = float(torch.log(torch.tensor(perplexity, dtype=C.dtype)) + 1.0)

    def entropy_gap(eps):
        log_P = _log_Pe(C, eps)
        log_P = log_P - torch.logsumexp(log_P, dim=1, keepdim=True)
        return entropy_red(log_P, log=True) - target_entropy

    if use_bounds:
        begin, end = _bounds_entropic_affinity(C, perplexity)
        begin = begin + 1e-6
    else:
        begin = end = None

    eps = binary_search(entropy_gap, n, begin=begin, end=end, max_iter=max_iter,
                        dtype=C.dtype, device=C.device)

    log_P = _log_Pe(C, eps)
    log_P = log_P - torch.logsumexp(log_P, dim=1, keepdim=True)
    log_P = log_P - torch.log(torch.tensor(float(n), dtype=C.dtype, device=C.device))
    return log_P, eps


class EntropicAffinity(SparseLogAffinity):
    r"""Directed entropic affinity (Hinton & Roweis 2002).

    Solves, row-wise by batched bisection on the bandwidth
    :math:`\varepsilon_i`, for row entropy :math:`\log(\xi) + 1` where
    :math:`\xi` is the perplexity. Sparsity keeps the :math:`3\xi` nearest
    neighbors.
    """

    def __init__(
        self,
        perplexity: float = 30,
        max_iter: int = 1000,
        sparsity: bool = True,
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
            sparsity=sparsity,
            **kwargs,
        )
        self.perplexity = perplexity
        self.max_iter = max_iter

    def _compute_sparse_log_affinity(self, X, return_indices: bool = True, **kwargs):
        n = X.shape[0]
        perplexity = check_neighbor_param(self.perplexity, n, logger=self.logger)

        if self.sparsity:
            k = check_neighbor_param(int(3 * perplexity), n, logger=self.logger)
            self.logger.info(f"Sparsity mode: computing {k} nearest neighbors.")
            C, indices = self._distance_matrix(X, k=k, return_indices=True)
        else:
            C, indices = self._distance_matrix(X, return_indices=True)

        log_P, eps = solve_entropic_affinity(C, perplexity, max_iter=self.max_iter)
        self.eps_ = eps
        return (log_P, indices) if return_indices else log_P
