"""Principal Component Analysis (counterpart of ``torchdr_tpu/models/spectral/pca.py``).

Two methods with deterministic signs: an SVD with the ``svd_flip``
convention, and the covariance method (a d×d ``eigh``) with the
largest-|entry|-positive convention. The rule that picks between them is
the JAX package's. A row-sharded input (what ``parallel.shard_rows``
returns: per-device row pieces) takes the covariance method, as a sharded
array does in the JAX package: each piece's device forms its partial Σx and
XcᵀXc, summed in rank order on the first piece's device, and the embedding
is gathered there.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ...base import DRModule
from ...ops.reductions import svd_flip
from ...parallel.mesh import ShardedRows
from ...utils.wrappers import restore_format, to_torch


def _pca_svd(X: torch.Tensor, n_components: int):
    mean = torch.mean(X, dim=0, keepdim=True)
    U, S, V = torch.linalg.svd(X - mean, full_matrices=False)
    U, V = svd_flip(U, V)
    components = V[:n_components]
    embedding = U[:, :n_components] * S[:n_components]
    return embedding, components, mean


def _pca_cov(X: torch.Tensor, n_components: int):
    """Covariance-method PCA: O(d²) memory."""
    mean = torch.mean(X, dim=0, keepdim=True)
    Xc = X - mean
    cov = torch.matmul(Xc.T, Xc) / X.shape[0]
    evals, evecs = torch.linalg.eigh(cov)
    order = torch.argsort(-evals)
    evecs = evecs[:, order]
    # deterministic sign: largest-|.| entry of each eigenvector positive
    max_abs = torch.argmax(torch.abs(evecs), dim=0)
    signs = torch.sign(evecs[max_abs, torch.arange(evecs.shape[1], device=X.device)])
    evecs = evecs * torch.where(signs == 0, torch.ones_like(signs), signs)[None, :]
    components = evecs[:, :n_components].T
    embedding = Xc @ components.T
    return embedding, components, mean


def _pca_cov_sharded(pieces: ShardedRows, n_components: int):
    """Covariance-method PCA of row pieces on their devices."""
    home = pieces[0].device
    n = pieces.shape[0]

    def psum(parts):
        total = None
        for part in parts:
            total = part.to(home) if total is None else total + part.to(home)
        return total

    mean = (psum(torch.sum(p, dim=0, keepdim=True) for p in pieces) / n)
    centred = [p - mean.to(p.device) for p in pieces]
    cov = psum(c.T @ c for c in centred) / n
    evals, evecs = torch.linalg.eigh(cov)
    evecs = evecs[:, torch.argsort(-evals)]
    max_abs = torch.argmax(torch.abs(evecs), dim=0)
    signs = torch.sign(evecs[max_abs, torch.arange(evecs.shape[1], device=home)])
    evecs = evecs * torch.where(signs == 0, torch.ones_like(signs), signs)[None, :]
    components = evecs[:, :n_components].T
    embedding = torch.cat([(c @ components.T.to(c.device)).to(home) for c in centred])
    return embedding, components, mean


class PCA(DRModule):
    """Principal Component Analysis.

    Parameters
    ----------
    n_components : int, default=2
    device : str, default="auto"
    verbose : bool, default=False
    random_state : int, optional
    method : {"auto", "svd", "covariance"}, default="auto"
        "auto" picks covariance for tall inputs (n > 8d and n > 4096).
    """

    def __init__(
        self,
        n_components: int = 2,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        method: str = "auto",
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
        self.method = method
        self.mean_ = None
        self.components_ = None

    def _resolve_method(self, X: torch.Tensor) -> str:
        if self.method != "auto":
            return self.method
        # Tall matrices: the d×d eigh is far cheaper than an n×d SVD.
        tall = X.shape[0] > 8 * X.shape[1] and X.shape[0] > 4096
        return "covariance" if (isinstance(X, ShardedRows) or tall) else "svd"

    def _fit_transform(self, X: torch.Tensor, y: Optional[Any] = None) -> torch.Tensor:
        method = self._resolve_method(X)
        if isinstance(X, ShardedRows):
            if method == "covariance":
                embedding, self.components_, self.mean_ = _pca_cov_sharded(X, self.n_components)
                return embedding
            X = torch.cat([p.to(X[0].device) for p in X])
        if method == "svd":
            embedding, self.components_, self.mean_ = _pca_svd(X, self.n_components)
        elif method == "covariance":
            embedding, self.components_, self.mean_ = _pca_cov(X, self.n_components)
        else:
            raise ValueError(f"[TorchDR-Torch] ERROR : unknown PCA method {method!r}.")
        return embedding

    def transform(self, X=None):
        """The training embedding, or new rows projected on the fitted
        components: (X − mean_) @ components_.T, on the fit's device in
        float32; a tensor comes back as a tensor."""
        if X is None:
            return super().transform(None)
        if self.mean_ is None:
            raise ValueError("PCA is not fitted yet.")
        Xt, fmt = to_torch(X, device=self.mean_.device, dtype=self.mean_.dtype)
        return restore_format((Xt - self.mean_) @ self.components_.T, fmt)
