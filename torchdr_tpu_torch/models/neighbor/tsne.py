"""t-SNE and SNE (counterpart of ``torchdr_tpu/models/neighbor/tsne.py``).

Input affinity: entropic (perplexity-calibrated, over the 3·perplexity
exact nearest neighbours). Attraction is a cross-entropy over the kNN
edges; the exact O(n²) repulsion runs through
``ops/reduce.pairwise_logkernel_rowlse``, whose forward is K2 and whose
backward is K3 on the card, so no n×n matrix is formed in either pass.
Gradients come by autograd of the loss. On the card (float32)
the attraction is ``ops/attraction.knn_attraction_loss``: one launch of A1
a step over each row's out-edges and in-edges, the in-edges listed once a
fit in the loop's constants; elsewhere it is the cross-entropy of a
``Z[NN]`` gather, by autograd. When the fit has a device mesh, the
repulsion is row-sharded over it
(``ops/reduce.pairwise_logkernel_rowlse_sharded``: the general K2 and K3
on every shard, every step); the attraction runs where Z lives.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ...affinity.entropic import EntropicAffinity
from ...ops.attraction import knn_attraction_loss, knn_transpose
from ...ops.distance import pairwise_distances_indexed
from ...ops.reduce import pairwise_logkernel_rowlse, pairwise_logkernel_rowlse_sharded
from ...ops.reductions import cross_entropy_loss
from .base import NeighborEmbedding


#: the loop's constants that hold the kNN graph's transpose (A1 reads them)
_TRANSPOSE = ("in_ptr", "in_src", "in_P")


def _rowlse_maybe_sharded(model, Z, kernel):
    """Row log-sum of the output kernel; row-sharded over the fit's mesh
    when it has one (the reference's per-rank row chunks)."""
    mesh = getattr(model, "_fit_mesh_", None)
    if mesh is not None:
        return pairwise_logkernel_rowlse_sharded(Z, mesh, kernel, True, model.block_size)
    return pairwise_logkernel_rowlse(Z, kernel, True, model.block_size)


class _EntropicNeighborEmbedding(NeighborEmbedding):
    """Shared set-up of t-SNE and SNE: the entropic input affinity. Its
    signature is SNE's; t-SNE's differs in the early-exaggeration defaults."""

    def __init__(
        self,
        perplexity: float = 30,
        n_components: int = 2,
        lr: Union[float, str] = "auto",
        optimizer: str = "SGD",
        optimizer_kwargs: Union[Dict, str, None] = "auto",
        scheduler: Optional[str] = None,
        scheduler_kwargs: Union[Dict, str, None] = None,
        init: str = "pca",
        init_scaling: float = 1e-4,
        min_grad_norm: float = 1e-7,
        max_iter: int = 2000,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        early_exaggeration_coeff: Optional[float] = None,
        early_exaggeration_iter: Optional[int] = None,
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
        self.metric = metric
        self.max_iter_affinity = max_iter_affinity
        self.sparsity = sparsity
        self.block_size = block_size
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
            early_exaggeration_coeff=early_exaggeration_coeff,
            early_exaggeration_iter=early_exaggeration_iter,
            check_interval=check_interval,
            **kwargs,
        )

    def _build_consts(self, X):
        """The loop's constants; on the card, also the kNN graph's transpose
        (``in_ptr``, ``in_src``, ``in_P``: ``ops/attraction.knn_transpose``)
        that A1 reads each edge's other end from."""
        consts = super()._build_consts(X)
        P, NN = consts["P"], consts.get("NN")
        if NN is not None and P.is_cuda and P.dtype == torch.float32:
            consts.update(zip(_TRANSPOSE, knn_transpose(NN, P)))
        return consts

    def _knn_sq_dists(self, Z, consts):
        return pairwise_distances_indexed(Z, key_indices=consts["NN"], metric="sqeuclidean")

    def _a1_attraction(self, Z, consts, kernel):
        """Σ P φ(d) over the kNN edges by A1, where the constants hold the
        transpose and Z is a float32 CUDA tensor; else None."""
        if "in_ptr" not in consts or not Z.is_cuda or Z.dtype != torch.float32:
            return None
        transpose = tuple(consts[key] for key in _TRANSPOSE)
        return knn_attraction_loss(Z, consts["P"], consts["NN"], transpose, kernel)


class TSNE(_EntropicNeighborEmbedding):
    """t-SNE (van der Maaten & Hinton 2008).

    Defaults follow the JAX package: lr="auto", SGD with "auto" momentum
    (0.5, then 0.8), early exaggeration 12.0 for 250 iterations, PCA init.

    On the card (float32) a step launches K2 and K3
    for the repulsion and A1 for the attraction, whose gradient it writes
    from each row's out-edges and in-edges (the kNN graph's transpose, built
    once a fit); elsewhere the attraction is autograd of a ``Z[NN]`` gather.
    """

    def __init__(
        self,
        perplexity: float = 30,
        n_components: int = 2,
        lr: Union[float, str] = "auto",
        optimizer: str = "SGD",
        optimizer_kwargs: Union[Dict, str, None] = "auto",
        scheduler: Optional[str] = None,
        scheduler_kwargs: Union[Dict, str, None] = None,
        init: str = "pca",
        init_scaling: float = 1e-4,
        min_grad_norm: float = 1e-7,
        max_iter: int = 2000,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        early_exaggeration_coeff: float = 12.0,
        early_exaggeration_iter: int = 250,
        max_iter_affinity: int = 100,
        metric: str = "sqeuclidean",
        sparsity: bool = True,
        check_interval: int = 50,
        knn_mode: str = "exact",
        knn_precision: str = "highest",
        block_size: int = 1024,
        **kwargs,
    ):
        super().__init__(
            perplexity=perplexity, n_components=n_components, lr=lr, optimizer=optimizer,
            optimizer_kwargs=optimizer_kwargs, scheduler=scheduler,
            scheduler_kwargs=scheduler_kwargs, init=init, init_scaling=init_scaling,
            min_grad_norm=min_grad_norm, max_iter=max_iter, device=device, verbose=verbose,
            random_state=random_state, early_exaggeration_coeff=early_exaggeration_coeff,
            early_exaggeration_iter=early_exaggeration_iter,
            max_iter_affinity=max_iter_affinity, metric=metric, sparsity=sparsity,
            check_interval=check_interval, knn_mode=knn_mode, knn_precision=knn_precision,
            block_size=block_size, **kwargs,
        )

    def _attractive_loss(self, Z, consts, carry, it):
        """Cross-entropy of P against the student log-kernel on the kNN edges
        (A1 on the card)."""
        loss = self._a1_attraction(Z, consts, "student")
        if loss is not None:
            return loss, carry
        log_Q = -torch.log1p(self._knn_sq_dists(Z, consts))
        return cross_entropy_loss(consts["P"], log_Q, log=True), carry

    def _repulsive_loss(self, Z, consts, carry, it):
        """log Σ_ij (1 + d²_ij)⁻¹ over all pairs i ≠ j (K2 forward, K3 backward;
        their general form on each shard of a mesh)."""
        row_lse = _rowlse_maybe_sharded(self, Z, "student")
        return torch.logsumexp(row_lse, dim=0), carry


class SNE(_EntropicNeighborEmbedding):
    """Stochastic Neighbor Embedding (Hinton & Roweis 2002): gaussian output
    kernel, row-wise log-normalization.

    On the card its step launches the same kernels as :class:`TSNE`'s, in
    their gaussian mode: K2 and K3 for the repulsion, A1 for the attraction.
    """

    def _attractive_loss(self, Z, consts, carry, it):
        """Cross-entropy of P against the gaussian log-kernel on the kNN edges
        (A1 on the card)."""
        loss = self._a1_attraction(Z, consts, "gaussian")
        if loss is not None:
            return loss, carry
        return cross_entropy_loss(consts["P"], -self._knn_sq_dists(Z, consts), log=True), carry

    def _repulsive_loss(self, Z, consts, carry, it):
        """(1/n) Σ_i log Σ_{j≠i} e^(−d²_ij) (K2 forward, K3 backward)."""
        row_lse = _rowlse_maybe_sharded(self, Z, "gaussian")
        return torch.sum(row_lse) / consts["n"], carry
