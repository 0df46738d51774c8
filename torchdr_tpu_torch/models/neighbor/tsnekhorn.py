"""TSNEkhorn (counterpart of ``torchdr_tpu/models/neighbor/tsnekhorn.py``).

P is a :class:`SymmetricEntropicAffinity` (or, with
``symmetric_affinity=False``, the directed :class:`EntropicAffinity`,
densified). Q is the student kernel of the embedding projected by
``sinkhorn_iter`` symmetric Sinkhorn iterations, warm-started each step
from the previous step's dual, which the loop carries. ``unrolling=True``
differentiates through the Sinkhorn iterations; otherwise only through
the cost. The loss is dense: O(n²) memory per step, formed by
``pairwise_distances`` as in the JAX package, with no kernel of its own.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from ...affinity.entropic import EntropicAffinity, SymmetricEntropicAffinity, sinkhorn_log
from ...ops.distance import pairwise_distances
from ...ops.reductions import cross_entropy_loss
from ...ops.sparse import sparse_to_dense
from .base import NeighborEmbedding


class TSNEkhorn(NeighborEmbedding):
    """TSNEkhorn (Van Assel et al. 2023)."""

    def __init__(
        self,
        perplexity: float = 30,
        n_components: int = 2,
        lr: Union[float, str] = "auto",
        optimizer: str = "SGD",
        optimizer_kwargs: Union[Dict, str, None] = "auto",
        scheduler: Optional[str] = None,
        scheduler_kwargs: Optional[Dict] = None,
        init: str = "pca",
        init_scaling: float = 1e-4,
        min_grad_norm: float = 1e-4,
        max_iter: int = 2000,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        lr_affinity_in: float = 1e-1,
        eps_square_affinity_in: bool = True,
        tol_affinity_in: float = 1e-3,
        max_iter_affinity_in: int = 100,
        metric: str = "sqeuclidean",
        unrolling: bool = False,
        symmetric_affinity: bool = True,
        sinkhorn_iter: int = 5,
        check_interval: int = 50,
        **kwargs,
    ):
        self.perplexity = perplexity
        self.metric = metric
        self.lr_affinity_in = lr_affinity_in
        self.eps_square_affinity_in = bool(eps_square_affinity_in)
        self.tol_affinity_in = tol_affinity_in
        self.max_iter_affinity_in = max_iter_affinity_in
        self.unrolling = bool(unrolling)
        self.symmetric_affinity = bool(symmetric_affinity)
        self.sinkhorn_iter = sinkhorn_iter

        if self.symmetric_affinity:
            affinity_in = SymmetricEntropicAffinity(
                perplexity=perplexity,
                lr=lr_affinity_in,
                eps_square=eps_square_affinity_in,
                metric=metric,
                tol=tol_affinity_in,
                max_iter=max_iter_affinity_in,
                device=device,
                verbose=verbose,
                zero_diag=False,
            )
        else:
            affinity_in = EntropicAffinity(
                perplexity=perplexity,
                metric=metric,
                max_iter=max_iter_affinity_in,
                device=device,
                verbose=verbose,
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
            check_interval=check_interval,
            **kwargs,
        )

    def _build_consts(self, X):
        consts = super()._build_consts(X)
        # the loss is dense (Sinkhorn over the full Q); densify a sparse P
        if consts.get("NN") is not None:
            consts["P"] = sparse_to_dense(consts["P"], consts["NN"], self.n_samples_in_)
        return consts

    def _init_carry(self, consts):
        carry = super()._init_carry(consts)
        carry["sinkhorn_dual"] = torch.zeros(
            (consts["n"],), dtype=torch.float32, device=consts["P"].device
        )
        return carry

    def _loss(self, Z, consts, carry, it, ee_coeff):
        """Gap objective CE(P, Q) + Σ Q, Q from a warm-started Sinkhorn."""
        n = consts["n"]
        D, _ = pairwise_distances(Z, metric="sqeuclidean", exclude_diag=True)
        log_K = -torch.log1p(D)  # student base kernel, eps = 1
        log_Q, dual = sinkhorn_log(
            log_K,
            carry["sinkhorn_dual"],
            tol=1e-5,
            max_iter=self.sinkhorn_iter,
            with_grad=self.unrolling,
        )
        log_Q = log_Q - math.log(n)
        carry = dict(carry, sinkhorn_dual=dual.detach())

        attractive = cross_entropy_loss(consts["P"], log_Q, log=True)
        if self.unrolling:
            repulsive = 0.0
        else:
            repulsive = torch.exp(torch.logsumexp(log_Q.reshape(-1), dim=0))
        return ee_coeff * attractive + self.repulsion_strength * repulsive, carry
