"""CO-SNE on the Poincaré ball (counterpart of ``torchdr_tpu/models/neighbor/cosne.py``).

Entropic input affinity; hyperbolic Cauchy output kernel; a term that
matches each point's hyperbolic distance to the origin to its input
squared norm; RiemannianAdam (expmap retraction, momentum transport).
Gradients come by autograd of the loss. The O(n²) repulsion is
``ops/reduce.pairwise_logkernel_rowlse_autodiff``: torch operations over
(block × n) tiles whose backward recomputes each tile, as the JAX package
computes it in XLA. No kernel of the port runs here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from ...affinity.entropic import EntropicAffinity
from ...ops.distance import pairwise_distances_indexed
from ...ops.metrics import acosh_above_one
from ...ops.reduce import pairwise_logkernel_rowlse_autodiff
from ...ops.reductions import cross_entropy_loss
from ...utils.manifold import poincare_expmap0
from .base import NeighborEmbedding


class COSNE(NeighborEmbedding):
    """CO-SNE (Guo et al. 2022).

    An entropic input affinity, the hyperbolic Cauchy output kernel
    Q_ij = γ / (d_H² + γ²), and a distance-to-origin preservation term
    weighted by ``learning_rate_for_h_loss``. The default ``init="pca"``
    maps the PCA layout, scaled to std ``init_scaling``, into the ball by
    the exponential map at the origin, as the JAX package does.
    """

    def __init__(
        self,
        perplexity: float = 30,
        learning_rate_for_h_loss: float = 1,
        gamma: float = 2,
        n_components: int = 2,
        lr: Union[float, str] = "auto",
        optimizer_kwargs: Union[Dict, str, None] = None,
        scheduler: Optional[str] = None,
        scheduler_kwargs: Optional[Dict] = None,
        init: str = "pca",
        init_scaling: float = 0.5,
        min_grad_norm: float = 1e-7,
        max_iter: int = 2000,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        max_iter_affinity: int = 100,
        metric: str = "sqeuclidean",
        sparsity: bool = True,
        check_interval: int = 50,
        knn_mode: str = "exact",
        knn_precision: str = "highest",
        block_size: int = 1024,
        **kwargs,
    ):
        self.perplexity = perplexity
        self.learning_rate_for_h_loss = learning_rate_for_h_loss
        self.gamma = gamma
        self.block_size = block_size
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
            optimizer="RiemannianAdam",
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
            check_interval=check_interval,
            **kwargs,
        )

    def _lr_plan(self):
        # "auto" is 1.0 for RiemannianAdam: the sklearn SGD rule would make
        # an Adam-style step explode
        if self.lr == "auto":
            return 1.0, 1.0
        return float(self.lr), float(self.lr)

    def _init_embedding(self, X, draw=None):
        if isinstance(self.init, str) and self.init == "pca":
            from ..spectral.pca import PCA

            emb = PCA(n_components=self.n_components, device=X.device)._fit_transform(X)
            std0 = torch.std(emb[:, 0], correction=0)
            emb = self.init_scaling * emb / torch.where(std0 > 0, std0, torch.ones_like(std0))
            return poincare_expmap0(emb).contiguous()
        return super()._init_embedding(X, draw)

    def _build_consts(self, X):
        consts = super()._build_consts(X)
        # the input-norm targets of the distance-to-origin term
        consts["X_norm"] = torch.sum(X * X, dim=-1)
        return consts

    def _attractive_loss(self, Z, consts, carry, it):
        D = pairwise_distances_indexed(Z, key_indices=consts["NN"], metric="sqhyperbolic")
        log_Q = torch.log(self.gamma / (D + self.gamma**2))
        return cross_entropy_loss(consts["P"], log_Q, log=True), carry

    def _repulsive_loss(self, Z, consts, carry, it):
        gamma = float(self.gamma)
        row_lse = pairwise_logkernel_rowlse_autodiff(
            Z,
            lambda D: math.log(gamma) - torch.log(D + gamma**2),
            metric="sqhyperbolic",
            exclude_diag=True,
            block_size=self.block_size,
        )
        rep = torch.logsumexp(row_lse, dim=0)
        # hyperbolic distance to the origin, squared, against the input's
        # squared norm (the same arccosh floor as ops/metrics.py)
        Y_norm = torch.sum(Z * Z, dim=-1)
        Y_norm = acosh_above_one(1 + 2 * (Y_norm / (1 - Y_norm))) ** 2
        distance_term = torch.mean((consts["X_norm"] - Y_norm) ** 2)
        return rep + self.learning_rate_for_h_loss * distance_term, carry
