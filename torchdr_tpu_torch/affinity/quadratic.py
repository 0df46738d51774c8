"""Doubly stochastic affinity with quadratic (L2) regularization.

Counterpart of ``torchdr_tpu/affinity/quadratic.py``: dual ascent with
Adam on f so that the rows of P = [f ⊕ f − C]₊ / ε sum to 1. The JAX
package's ``lax.while_loop`` is a Python loop that tests its stop
condition every ``_SYNC_EVERY`` iterations and masks out the updates of
iterations that start after it was met, with the result of testing every
iteration.
"""

from __future__ import annotations

import torch

from ..utils.optim import make_optimizer
from .base import Affinity
from .entropic import _SYNC_EVERY


def _Pds(C: torch.Tensor, dual: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.clamp(dual[:, None] + dual[None, :] - C, min=0.0) / eps


def _solve_quadratic_ds(C, eps, lr, tol, max_iter, optimizer="Adam"):
    """Returns (P / n, dual, n_iter); stops after the first iteration whose
    marginal gradient has norm < tol."""
    n = C.shape[0]
    opt = make_optimizer(optimizer)
    dual = torch.ones((n,), dtype=C.dtype, device=C.device)
    state = opt.init(dual)
    stopped = torch.zeros((), dtype=torch.bool, device=C.device)
    n_iter = torch.zeros((), dtype=torch.int64, device=C.device)
    for it in range(int(max_iter)):
        if it and it % _SYNC_EVERY == 0 and bool(stopped):
            break
        grad = torch.sum(_Pds(C, dual, eps), dim=1) - 1.0
        new, state = opt.update(grad, state, dual, lr, {})
        dual = torch.where(stopped, dual, new)
        n_iter = n_iter + (~stopped).long()
        stopped = stopped | (torch.linalg.vector_norm(grad) < tol)
    return _Pds(C, dual, eps) / n, dual, int(n_iter)


class DoublyStochasticQuadraticAffinity(Affinity):
    r"""L2-regularized symmetric OT affinity (Zhang et al. 2023).

    P = [f ⊕ f − C]₊ / ε with dual ascent on f so that rows sum to 1, then
    scaled to total mass 1.
    """

    def __init__(
        self,
        eps: float = 1.0,
        tol: float = 1e-5,
        max_iter: int = 1000,
        optimizer: str = "Adam",
        lr: float = 1e0,
        base_kernel: str = "gaussian",
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        **kwargs,
    ):
        super().__init__(
            metric=metric, zero_diag=zero_diag, device=device, verbose=verbose, **kwargs
        )
        self.eps = eps
        self.tol = tol
        self.max_iter = max_iter
        self.optimizer = optimizer
        self.lr = lr
        self.base_kernel = base_kernel

    def _compute_affinity(self, X: torch.Tensor):
        C = self._distance_matrix(X)
        if self.base_kernel == "student":
            C = torch.log1p(C)
        P, dual, n_iter = _solve_quadratic_ds(
            C, float(self.eps), float(self.lr), float(self.tol), int(self.max_iter),
            optimizer=self.optimizer,
        )
        self.dual_ = dual
        self.n_iter_ = n_iter
        return P
