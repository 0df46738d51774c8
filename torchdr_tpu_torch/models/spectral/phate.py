"""PHATE (counterpart of ``torchdr_tpu/models/spectral/phate.py``).

An :class:`AffinityMatcher` whose input affinity is the negative potential
distance of :class:`PHATEAffinity` and whose loss is the normalized stress
of metric MDS, differentiated by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...affinity.knn_normalized import PHATEAffinity
from ...affinity_matcher import AffinityMatcher
from ...ops.distance import pairwise_distances


class PHATE(AffinityMatcher):
    """PHATE (Moon et al. 2019).

    Minimizes sqrt(Σ (P + ‖z_i − z_j‖)² / Σ P²) where P holds the negative
    potential distances.
    """

    def __init__(
        self,
        n_components: int = 2,
        k: int = 5,
        t: int = 100,
        alpha: float = 10.0,
        optimizer: str = "Adam",
        optimizer_kwargs: Optional[dict] = None,
        lr: float = 1e0,
        scheduler: Optional[str] = None,
        scheduler_kwargs: Optional[dict] = None,
        min_grad_norm: float = 1e-15,
        max_iter: int = 1000,
        init: str = "pca",
        init_scaling: float = 1e-4,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        check_interval: int = 50,
        metric_in: str = "euclidean",
        **kwargs,
    ):
        self.k = k
        self.t = t
        self.alpha = alpha
        self.metric_in = metric_in

        affinity_in = PHATEAffinity(
            k=k, t=t, alpha=alpha, metric=metric_in, device=device, verbose=verbose
        )
        super().__init__(
            affinity_in=affinity_in,
            n_components=n_components,
            optimizer=optimizer,
            optimizer_kwargs=optimizer_kwargs,
            lr=lr,
            scheduler=scheduler,
            scheduler_kwargs=scheduler_kwargs,
            min_grad_norm=min_grad_norm,
            max_iter=max_iter,
            init=init,
            init_scaling=init_scaling,
            device=device,
            verbose=verbose,
            random_state=random_state,
            check_interval=check_interval,
            **kwargs,
        )

    def _loss(self, Z, consts, carry, it, ee_coeff):
        D, _ = pairwise_distances(Z, metric="sqeuclidean")
        Q = -torch.sqrt(torch.clamp(D, min=1e-12))
        P = consts["P"]
        loss = torch.sum((P - Q) ** 2) / torch.sum(P**2)
        return torch.sqrt(loss), carry
