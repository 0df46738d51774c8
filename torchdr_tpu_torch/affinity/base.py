"""Affinity base hierarchy (counterpart of ``torchdr_tpu/affinity/base.py``).

- :class:`Affinity` — dense ``(n, n)`` affinity in probability domain.
- :class:`LogAffinity` — dense, computed in log domain.
- :class:`SparseAffinity` — rectangular padded ``(n, k)`` values + indices.
- :class:`SparseLogAffinity` — sparse, computed in log domain.

``zero_diag`` excludes the self-distance by masking it to ``MASK_VALUE``.
``knn_mode="ivf"`` (or a :class:`KnnConfig` with mode "ivf") builds the
kNN graph through ``ops/ivf.ivf_knn``. With a device mesh (``mesh=``, or
injected by an estimator through ``_set_fit_mesh``) the exact kNN graph is
built with row-sharded queries over the mesh (``parallel/knn``), and the
IVF graph by ``parallel/ivf.ivf_knn_sharded``.
"""

from __future__ import annotations

from abc import ABC
from typing import Dict, Optional

import torch

from ..base import BaseEstimator, resolve_device
from ..ops.distance import knn_graph, pairwise_distances
from ..ops.ivf import ivf_knn
from ..ops.knn_config import KnnConfig
from ..parallel.ivf import ivf_knn_sharded
from ..parallel.knn import knn_graph_sharded
from ..parallel.mesh import check_mesh
from ..utils.logger import get_logger, log_phase
from ..utils.wrappers import full_float32, to_torch


class Affinity(BaseEstimator, ABC):
    """Base class for dense affinity matrices.

    ``__call__`` moves its input to ``device`` ("auto" = the CUDA card,
    raising without one) and computes there. ``timings_`` holds the wall
    time of the last kNN build ("knn").
    """

    def __init__(
        self,
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        knn_mode: str = "exact",
        knn_precision: str = "highest",
        mesh=None,
        **kwargs,
    ):
        self.metric = metric
        self.zero_diag = bool(zero_diag)
        self.device = device if device is not None else "auto"
        self.verbose = bool(verbose)
        self.random_state = random_state
        # device mesh of the build phase; an estimator injects its fit mesh
        # through _set_fit_mesh
        self.mesh = check_mesh(mesh)
        cfg = knn_mode if isinstance(knn_mode, KnnConfig) else KnnConfig(
            mode=knn_mode, precision=knn_precision
        )
        self._knn_cfg = cfg
        self.knn_mode = cfg.mode
        self.knn_precision = cfg.precision
        self.knn_block_size = cfg.block_size
        self.logger = get_logger(type(self).__name__, self.verbose)
        self.timings_: Dict[str, float] = {}

    # --- mesh plumbing (estimators inject their fit mesh here) ---

    def _set_fit_mesh(self, mesh) -> None:
        """Called by estimators so that the build phase shards over their mesh."""
        self._fit_mesh = check_mesh(mesh)

    def _active_mesh(self):
        m = getattr(self, "_fit_mesh", None)
        return m if m is not None else self.mesh

    def _device(self) -> torch.device:
        return resolve_device(self.device, self._active_mesh())

    def _timings(self) -> Dict[str, float]:
        """``timings_``, made anew after :meth:`clear_memory`."""
        return self.__dict__.setdefault("timings_", {})

    def clear_memory(self):
        """Delete the public fitted attributes (the names ending in ``_``)."""
        for name in list(vars(self)):
            if name.endswith("_") and not name.startswith("_"):
                delattr(self, name)

    @full_float32()
    def __call__(self, X, **kwargs):
        X, _ = to_torch(X, device=self._device())
        return self._compute_affinity(X, **kwargs)

    def _compute_affinity(self, X: torch.Tensor, **kwargs):
        raise NotImplementedError(
            "[TorchDR-Torch] ERROR : `_compute_affinity` method is not implemented."
        )

    def _distance_matrix(
        self, X: torch.Tensor, k: Optional[int] = None, return_indices: bool = False
    ):
        """Pairwise distances; ``(n, k)`` kNN form when ``k`` is given."""
        if self.metric in ("sqeuclidean", "euclidean"):
            # The norms+gram form ‖x‖²+‖y‖²−2⟨x,y⟩ cancels in float32 when
            # the data sits far from the origin; centering restores the
            # conditioning exactly (distances are translation invariant).
            X = X - torch.mean(X, dim=0, keepdim=True)
        if k is None:
            C, _ = pairwise_distances(X, metric=self.metric, exclude_diag=self.zero_diag)
            return (C, None) if return_indices else C
        mesh = self._active_mesh()
        if mesh is not None and self.knn_mode != "ivf":
            with log_phase(self.logger, "knn", self._timings(), X.device):
                C, indices = knn_graph_sharded(
                    X, k=k, mesh=mesh, metric=self.metric, exclude_diag=self.zero_diag,
                    block_size=self.knn_block_size, mode=self.knn_mode,
                    precision=self.knn_precision,
                )
            return (C, indices) if return_indices else C
        if self.knn_mode == "ivf":
            if self.metric not in ("sqeuclidean", "euclidean"):
                raise ValueError("[TorchDR-Torch] ERROR : IVF tier supports (sq)euclidean only.")
            cfg = self._knn_cfg
            ivf_kwargs = dict(
                k=k, nprobe=cfg.nprobe, n_clusters=cfg.n_clusters,
                exclude_self=self.zero_diag, budget=cfg.budget, merge=cfg.merge,
                nomination=cfg.nomination, rerank=cfg.rerank, m=cfg.m, storage=cfg.storage,
            )
            if cfg.ivf_block is not None:
                ivf_kwargs["block"] = int(cfg.ivf_block)
            with log_phase(self.logger, "knn", self._timings(), X.device):
                if mesh is not None:
                    C, indices = ivf_knn_sharded(X, mesh=mesh, **ivf_kwargs)
                else:
                    C, indices = ivf_knn(X, **ivf_kwargs)
                if self.metric == "euclidean":
                    C = torch.sqrt(torch.clamp(C, min=0.0))
            return (C, indices) if return_indices else C
        with log_phase(self.logger, "knn", self._timings(), X.device):
            C, indices = knn_graph(
                X,
                k=k,
                metric=self.metric,
                exclude_diag=self.zero_diag,
                mode=self.knn_mode,
                precision=self.knn_precision,
                block_size=self.knn_block_size,
            )
        return (C, indices) if return_indices else C


class LogAffinity(Affinity, ABC):
    """Affinity computed in log domain; ``__call__(X, log=True)`` returns logs."""

    @full_float32()
    def __call__(self, X, log: bool = False, **kwargs):
        X, _ = to_torch(X, device=self._device())
        log_aff = self._compute_log_affinity(X, **kwargs)
        return log_aff if log else torch.exp(log_aff)

    def _compute_log_affinity(self, X: torch.Tensor, **kwargs):
        raise NotImplementedError(
            "[TorchDR-Torch] ERROR : `_compute_log_affinity` method is not implemented."
        )


class SparseAffinity(Affinity, ABC):
    """Affinity with a rectangular padded ``(n, k)`` representation.

    The sparse representation is a (values, indices) pair; padding slots
    hold value 0 / index -1.
    """

    def __init__(
        self,
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        sparsity: bool = True,
        **kwargs,
    ):
        super().__init__(
            metric=metric,
            zero_diag=zero_diag,
            device=device,
            verbose=verbose,
            random_state=random_state,
            **kwargs,
        )
        self.sparsity = bool(sparsity)

    @full_float32()
    def __call__(self, X, return_indices: bool = True, **kwargs):
        X, _ = to_torch(X, device=self._device())
        return self._compute_sparse_affinity(X, return_indices=return_indices, **kwargs)

    def _compute_sparse_affinity(self, X: torch.Tensor, return_indices: bool = True, **kwargs):
        raise NotImplementedError(
            "[TorchDR-Torch] ERROR : `_compute_sparse_affinity` is not implemented."
        )


class SparseLogAffinity(SparseAffinity, ABC):
    """Sparse affinity computed in log domain.

    ``__call__`` returns probabilities by default (padding slots, index -1,
    hold 0); ``log=True`` returns the log values.
    """

    @full_float32()
    def __call__(self, X, return_indices: bool = True, log: bool = False, **kwargs):
        X, _ = to_torch(X, device=self._device())
        result = self._compute_sparse_log_affinity(X, return_indices=return_indices, **kwargs)
        if return_indices:
            log_aff, indices = result
            return (log_aff if log else self._masked_exp(log_aff, indices)), indices
        return result if log else torch.exp(result)

    @staticmethod
    def _masked_exp(log_aff: torch.Tensor, indices: Optional[torch.Tensor]) -> torch.Tensor:
        aff = torch.exp(log_aff)
        if indices is not None:
            aff = torch.where(indices >= 0, aff, torch.zeros_like(aff))
        return aff

    def _compute_sparse_log_affinity(self, X: torch.Tensor, return_indices: bool = True, **kwargs):
        raise NotImplementedError(
            "[TorchDR-Torch] ERROR : `_compute_sparse_log_affinity` is not implemented."
        )
