"""LargeVis and InfoTSNE (counterpart of ``torchdr_tpu/models/neighbor/largevis.py``).

Both take the entropic input affinity over the 3·perplexity nearest
neighbours and an O(n) repulsion over negative samples: by default one
shared uniform sample of S points per step, each term weighted by
n_negatives / S (``_shared_negative_sqdists``), or ``n_negatives``
per-point draws that skip each row itself (``shared_negatives=False``).
Gradients come by autograd of the loss, as for t-SNE. The repulsion terms
are torch operations: they are not K1's function, and the JAX package
computes them in XLA too.

Every repulsion takes its draw as an optional argument (``neg_ids`` for
the shared sample, ``u`` for the per-point uniform draw), so a test can
hand in the numbers the JAX package drew.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ...affinity.entropic import EntropicAffinity
from ...ops.distance import pairwise_distances_indexed
from ...ops.reductions import cross_entropy_loss
from .base import NegativeSamplingNeighborEmbedding


def _largevis_q(D: torch.Tensor) -> torch.Tensor:
    """LargeVis' similarity as the JAX package forms it: q = 1/(1 + D),
    then q / (q + 1)."""
    Q = 1.0 / (1.0 + D)
    return Q / (Q + 1.0)


class _EntropicNegativeSampling(NegativeSamplingNeighborEmbedding):
    """Shared EntropicAffinity + negative-sampling scaffold."""

    def __init__(
        self,
        perplexity: float = 30,
        n_components: int = 2,
        lr: Union[float, str] = "auto",
        optimizer: str = "SGD",
        optimizer_kwargs: Union[Dict, str, None] = "auto",
        scheduler: Optional[str] = None,
        scheduler_kwargs: Union[Dict, str, None] = "auto",
        init: str = "pca",
        init_scaling: float = 1e-4,
        min_grad_norm: float = 1e-7,
        max_iter: int = 1000,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        max_iter_affinity: int = 100,
        metric: str = "sqeuclidean",
        n_negatives: int = 5,
        sparsity: bool = True,
        early_exaggeration_coeff: Optional[float] = None,
        early_exaggeration_iter: Optional[int] = None,
        check_interval: int = 50,
        knn_mode: str = "exact",
        knn_precision: str = "highest",
        discard_NNs: bool = False,
        **kwargs,
    ):
        self.perplexity = perplexity
        self.metric = metric
        self.max_iter_affinity = max_iter_affinity
        self.sparsity = sparsity
        self.knn_mode = knn_mode
        self.knn_precision = knn_precision

        affinity_in = EntropicAffinity(
            perplexity=perplexity,
            metric=metric,
            max_iter=max_iter_affinity,
            device=device,
            verbose=verbose,
            sparsity=sparsity,
            knn_mode=knn_mode,
            knn_precision=knn_precision,
        )
        super().__init__(
            affinity_in=affinity_in,
            n_components=n_components,
            optimizer=optimizer,
            optimizer_kwargs=optimizer_kwargs,
            min_grad_norm=min_grad_norm,
            max_iter=max_iter,
            lr=lr,
            scheduler=scheduler,
            scheduler_kwargs=scheduler_kwargs,
            init=init,
            init_scaling=init_scaling,
            device=device,
            verbose=verbose,
            random_state=random_state,
            early_exaggeration_coeff=early_exaggeration_coeff,
            early_exaggeration_iter=early_exaggeration_iter,
            n_negatives=n_negatives,
            check_interval=check_interval,
            discard_NNs=discard_NNs,
            **kwargs,
        )

    def _knn_sq_dists(self, Z, consts):
        return pairwise_distances_indexed(Z, key_indices=consts["NN"], metric="sqeuclidean")

    def _per_point_sq_dists(self, Z, consts, u=None):
        neg = self._sample_negatives(consts, u=u)
        return pairwise_distances_indexed(Z, key_indices=neg, metric="sqeuclidean")


class LargeVis(_EntropicNegativeSampling):
    """LargeVis (Tang et al. 2016).

    Student attraction and Bernoulli repulsion -Σ log(1 - Q) over the
    negatives. Default scheduler LinearLR.
    """

    def __init__(self, *args, scheduler: Optional[str] = "LinearLR", **kwargs):
        super().__init__(*args, scheduler=scheduler, **kwargs)

    def _attractive_loss(self, Z, consts, carry, it):
        return cross_entropy_loss(consts["P"], _largevis_q(self._knn_sq_dists(Z, consts))), carry

    def _repulsive_loss(self, Z, consts, carry, it, neg_ids=None, u=None):
        n = consts["n"]
        if self.shared_negatives:
            # one shared uniform sample, rescaled to n_negatives per point
            D, valid, _ = self._shared_negative_sqdists(Z, consts, neg_ids)
            terms = torch.where(valid, torch.log(1.0 - _largevis_q(D)), torch.zeros_like(D))
            scale = self.n_negatives / D.shape[1]
            return -scale * torch.sum(terms) / n, carry
        Q = _largevis_q(self._per_point_sq_dists(Z, consts, u))
        return -torch.sum(torch.log(1.0 - Q)) / n, carry


class InfoTSNE(_EntropicNegativeSampling):
    """InfoTSNE (Damrich et al. 2023): InfoNCE repulsion over the
    negatives; defaults n_negatives=300 and early exaggeration 12 for 250
    steps."""

    def __init__(
        self,
        perplexity: float = 30,
        n_negatives: int = 300,
        early_exaggeration_coeff: Optional[float] = 12,
        early_exaggeration_iter: Optional[int] = 250,
        **kwargs,
    ):
        super().__init__(
            perplexity=perplexity,
            n_negatives=n_negatives,
            early_exaggeration_coeff=early_exaggeration_coeff,
            early_exaggeration_iter=early_exaggeration_iter,
            **kwargs,
        )

    def _attractive_loss(self, Z, consts, carry, it):
        log_Q = -torch.log1p(self._knn_sq_dists(Z, consts))
        return cross_entropy_loss(consts["P"], log_Q, log=True), carry

    def _repulsive_loss(self, Z, consts, carry, it, neg_ids=None, u=None):
        n = consts["n"]
        if self.shared_negatives:
            # InfoNCE over the shared set; the log(n_negatives / S) shift
            # keeps the loss on the per-point scale and leaves the gradient
            # (a softmax over the negatives) unchanged
            D, valid, _ = self._shared_negative_sqdists(Z, consts, neg_ids)
            log_Q = torch.where(valid, -torch.log1p(D), torch.full_like(D, float("-inf")))
            shift = torch.log(torch.tensor(self.n_negatives / D.shape[1], dtype=D.dtype))
            return torch.sum(torch.logsumexp(log_Q, dim=1) + shift) / n, carry
        log_Q = -torch.log1p(self._per_point_sq_dists(Z, consts, u))
        return torch.sum(torch.logsumexp(log_Q, dim=1)) / n, carry
