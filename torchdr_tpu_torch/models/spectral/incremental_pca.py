"""Incremental PCA (Ross et al. 2008) and exact two-pass incremental PCA.

Counterpart of ``torchdr_tpu/models/spectral/incremental_pca.py``, with its
split of the work between the host and the device:

- the running statistics (Welford mean and variance, the batch mean and
  the mean-correction row of each update) are O(batch · d) and run on the
  host in numpy float64, as in the JAX package; ``mean_`` and ``var_`` are
  host float64 arrays;
- the heavy per-batch products run on the estimator's device in float32
  (TF32 off): the SVD of IncrementalPCA's augmented matrix, the Σx and XᵀX
  of ExactIncrementalPCA (summed on the host in float64, then one host
  float64 ``eigh``), and the projection of every batch. The JAX package
  projects on the host in numpy; the port keeps the fitted components on
  the device and projects there.

Input: an array or tensor (taken in ``batch_size`` row slices), or any
iterable of row batches (arrays, tensors, or ``(x, y)`` pairs as a
DataLoader yields them). ``ExactIncrementalPCA`` takes a device mesh
(``mesh=``): each batch's statistics are row-sharded over it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ...base import DRModule
from ...ops.reductions import svd, svd_flip
from ...parallel.mesh import check_mesh, shard_rows
from ...utils.wrappers import restore_format, to_torch


def _host(batch) -> np.ndarray:
    if isinstance(batch, torch.Tensor):
        return batch.detach().cpu().numpy()
    return np.asarray(batch)


def _is_array(X) -> bool:
    return isinstance(X, (np.ndarray, torch.Tensor)) or hasattr(X, "__array__")


def _iter_batches(X, batch_size: Optional[int]):
    """Yield host numpy row batches from an array or tensor (``batch_size``
    rows each, default max(5 d, 100)) or from an iterable of batches."""
    if _is_array(X):
        Xn = _host(X)
        bs = batch_size or max(5 * Xn.shape[1], 100)
        for i in range(0, Xn.shape[0], bs):
            yield Xn[i : i + bs]
        return
    for batch in X:
        if isinstance(batch, (list, tuple)):  # (x, y) from a DataLoader
            batch = batch[0]
        yield _host(batch)


def _format(X) -> str:
    if isinstance(X, torch.Tensor):
        return "torch"
    return "numpy"


class IncrementalPCA(DRModule):
    """Incremental PCA by SVD updates of an augmented matrix.

    Parameters
    ----------
    n_components : int, default=2
    batch_size : int, optional
        Rows per update; default 5 * n_features.
    lowrank : bool, default=False
        Kept for API parity, as in the JAX package: one SVD of the small
        augmented matrix is already cheap.
    """

    def __init__(
        self,
        n_components: int = 2,
        batch_size: Optional[int] = None,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        lowrank: bool = False,
        **kwargs,
    ):
        super().__init__(
            n_components=n_components,
            device=device,
            verbose=verbose,
            random_state=random_state,
            process_duplicates=False,
            **kwargs,
        )
        self.batch_size = batch_size
        self.lowrank = lowrank
        self._reset()

    def _reset(self):
        self.mean_ = None
        self.var_ = None
        self.n_samples_seen_ = 0
        self.components_ = None
        self.singular_values_ = None
        self.noise_variance_ = None

    @staticmethod
    def _incremental_mean_and_var(Xb, last_mean, last_var, last_count):
        """Welford update of the column means and variances, host float64."""
        n_new = Xb.shape[0]
        new_count = last_count + n_new
        new_sum = Xb.sum(axis=0, dtype=np.float64)
        last_sum = (
            np.zeros(Xb.shape[1], np.float64) if last_mean is None else last_mean * last_count
        )
        updated_mean = (last_sum + new_sum) / new_count

        T = new_sum / n_new
        temp = Xb.astype(np.float64) - T
        correction = temp.sum(axis=0) ** 2
        new_unnorm_var = (temp**2).sum(axis=0) - correction / n_new
        if last_var is None:
            updated_var = new_unnorm_var / new_count
        else:
            last_unnorm_var = last_var * last_count
            ratio = last_count / n_new
            updated_var = (
                last_unnorm_var
                + new_unnorm_var
                + ratio / new_count * (last_sum / ratio - new_sum) ** 2
            ) / new_count
        return updated_mean, updated_var, new_count

    def partial_fit(self, X) -> "IncrementalPCA":
        """Update the model with one batch."""
        device = self._resolve_device()
        Xb = np.asarray(_host(X), np.float32)
        if Xb.ndim != 2:
            raise ValueError("[TorchDR-Torch] ERROR : batch must be 2D.")
        n_samples, n_features = Xb.shape
        first_pass = self.components_ is None
        if self.n_components > n_features:
            raise ValueError(
                f"[TorchDR-Torch] ERROR : n_components={self.n_components} exceeds "
                f"n_features={n_features}."
            )
        if first_pass and n_samples < self.n_components:
            raise ValueError(
                f"[TorchDR-Torch] ERROR : first batch has {n_samples} rows, fewer "
                f"than n_components={self.n_components}."
            )
        if not first_pass and n_features != self.mean_.shape[0]:
            raise ValueError(
                f"n_features={self.mean_.shape[0]} while input has {n_features} features"
            )

        col_mean, col_var, n_total = self._incremental_mean_and_var(
            Xb, self.mean_, self.var_, self.n_samples_seen_
        )

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        if first_pass:
            stacked = dev(Xb - col_mean)
        else:
            batch_mean = Xb.mean(axis=0)
            corr_factor = np.sqrt((self.n_samples_seen_ / n_total) * n_samples)
            mean_correction = corr_factor * (self.mean_ - batch_mean)
            stacked = torch.cat([
                self.singular_values_[:, None] * self.components_,
                dev(Xb - batch_mean),
                dev(mean_correction[None, :]),
            ])

        U, S, Vt = svd(stacked)
        U, Vt = svd_flip(U, Vt, u_based_decision=False)
        k = self.n_components
        explained_variance = S**2 / max(n_total - 1, 1)

        self.n_samples_seen_ = int(n_total)
        self.components_ = Vt[:k]
        self.singular_values_ = S[:k]
        self.mean_ = col_mean
        self.var_ = col_var
        self.explained_variance_ = explained_variance[:k]
        total_var = float((col_var * n_total).sum())
        self.explained_variance_ratio_ = (
            S[:k] ** 2 / total_var if total_var > 0 else torch.zeros_like(S[:k])
        )
        self.noise_variance_ = (
            float(explained_variance[k:].mean()) if explained_variance.shape[0] > k else 0.0
        )
        self.is_fitted_ = True
        return self

    def _fit_transform(self, X: torch.Tensor, y: Optional[Any] = None) -> torch.Tensor:
        return self._fit_transform_any(X)

    def fit_transform(self, X, y=None):
        """Fit on an array, a tensor or an iterable of batches and return
        the projection of every row (a tensor on the device for tensor
        input, else a numpy array)."""
        self._resolve_device()
        self._input_format_ = _format(X)
        self.embedding_ = self._fit_transform_any(X)
        self.is_fitted_ = True
        return restore_format(self.embedding_, self._input_format_)

    def _fit_transform_any(self, X):
        self._reset()
        batches = list(_iter_batches(X, self.batch_size))
        # as sklearn: a last batch thinner than n_components cannot be
        # SVD-updated; it joins the batch before it
        if len(batches) > 1 and batches[-1].shape[0] < self.n_components:
            batches[-2] = np.concatenate([batches[-2], batches[-1]], axis=0)
            batches.pop()
        for batch in batches:
            self.partial_fit(batch)
        return torch.cat([self._project(b) for b in batches])

    def _project(self, Xb) -> torch.Tensor:
        X, _ = to_torch(Xb, device=self.device_)
        mean = torch.from_numpy(np.asarray(self.mean_, np.float32)).to(self.device_)
        return (X - mean) @ self.components_.T

    def transform(self, X=None):
        if X is None:
            return super().transform(None)
        if self.components_ is None:
            raise ValueError("IncrementalPCA is not fitted yet.")
        return restore_format(self._project(X), _format(X))


class ExactIncrementalPCA(DRModule):
    """Exact two-pass PCA accumulating XᵀX batch by batch.

    Pass 1 takes Σx and XᵀX of each batch on the device in float32 and sums
    them on the host in float64; one host float64 ``eigh`` of the d × d
    covariance gives the components. Pass 2 projects every batch on the
    device. A one-shot iterator of batches is materialised once, since both
    passes read every batch.

    With a device mesh (``mesh=``, or injected by ``_set_fit_mesh``) each
    batch is row-sharded over it: every shard's device takes the Σx and XᵀX
    of its rows, and the partial sums are added on the fit's device in rank
    order (the JAX package's psum) before the host float64 accumulation.
    """

    def __init__(
        self,
        n_components: int = 2,
        batch_size: Optional[int] = None,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        mesh=None,
        **kwargs,
    ):
        super().__init__(
            n_components=n_components,
            device=device,
            verbose=verbose,
            random_state=random_state,
            process_duplicates=False,
            **kwargs,
        )
        self.batch_size = batch_size
        self.mesh = check_mesh(mesh)
        self._fit_mesh_ = self.mesh
        self.mean_ = None
        self.components_ = None

    def _set_fit_mesh(self, mesh) -> None:
        """The mesh-injection protocol of the affinities."""
        self._fit_mesh_ = check_mesh(mesh)

    def _resolve_mesh(self):
        return self._fit_mesh_

    def _batch_stats(self, Xb: torch.Tensor):
        """Σx and XᵀX of one batch (float32), over the fit's mesh when it
        has one."""
        mesh = self._fit_mesh_
        if mesh is None:
            return torch.sum(Xb, dim=0), Xb.T @ Xb
        s = g = None
        for piece in shard_rows(Xb, mesh):
            s_r, g_r = torch.sum(piece, dim=0).to(Xb.device), (piece.T @ piece).to(Xb.device)
            s, g = (s_r, g_r) if s is None else (s + s_r, g + g_r)
        return s, g

    def fit(self, X, y=None):
        self.fit_transform(X, y)
        return self

    def _fit_stats(self, batches):
        device = self.device_
        d = batches[0].shape[1]
        total = 0
        sum_x = np.zeros(d, np.float64)
        gram = np.zeros((d, d), np.float64)
        for b in batches:
            Xb = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(device)
            s, g = self._batch_stats(Xb)
            sum_x += s.double().cpu().numpy()
            gram += g.double().cpu().numpy()
            total += b.shape[0]
        mean = sum_x / total
        cov = gram / total - np.outer(mean, mean)
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1]
        evecs = evecs[:, order]
        max_abs = np.argmax(np.abs(evecs), axis=0)
        signs = np.sign(evecs[max_abs, np.arange(evecs.shape[1])])
        evecs = evecs * np.where(signs == 0, 1.0, signs)[None, :]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        self.mean_ = dev(mean)
        self.components_ = dev(evecs[:, : self.n_components].T)
        self.explained_variance_ = dev(evals[order][: self.n_components])
        self.n_samples_seen_ = total
        self.is_fitted_ = True
        return self

    def fit_transform(self, X, y=None):
        """Both passes; returns the projection of every row (a tensor on the
        device for tensor input, else a numpy array)."""
        self._resolve_device()
        self._input_format_ = _format(X)
        batches = list(_iter_batches(X, self.batch_size))
        self._fit_stats(batches)
        self.embedding_ = torch.cat([self._project(b) for b in batches])
        return restore_format(self.embedding_, self._input_format_)

    def _fit_transform(self, X, y=None):
        self.fit_transform(X, y)
        return self.embedding_

    def _project(self, Xb) -> torch.Tensor:
        X, _ = to_torch(Xb, device=self.device_)
        return (X - self.mean_) @ self.components_.T

    def transform(self, X=None):
        if X is None:
            return super().transform(None)
        if self.components_ is None:
            raise ValueError("ExactIncrementalPCA is not fitted yet.")
        return restore_format(self._project(X), _format(X))
