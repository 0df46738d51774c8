"""Affinities with entropic constraints.

Counterpart of ``torchdr_tpu/affinity/entropic.py``:

- :class:`EntropicAffinity` (t-SNE's and SNE's input affinity): a batched
  bisection on each row's bandwidth through ``ops/root_search``;
- :class:`SymmetricEntropicAffinity` (TSNEkhorn's): dual ascent on
  (ε, μ) with Adam, or L-BFGS with a strong-Wolfe line search on the
  explicit dual (:func:`sea_dual_value`, gradients by autograd);
- :class:`SinkhornAffinity` and :func:`sinkhorn_log`: log-domain symmetric
  Sinkhorn with a warm-startable dual;
- :class:`NormalizedGaussianAffinity`, :class:`NormalizedStudentAffinity`.

The JAX package's ``lax.while_loop`` solvers are Python loops here. Those
that stop on a tolerance test it every ``_SYNC_EVERY`` iterations, and an
iteration that starts after the test was met changes nothing (its update
is masked out), so the result is that of testing every iteration, with
one host read per ``_SYNC_EVERY`` iterations.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ..ops.reductions import entropy as entropy_red
from ..ops.root_search import binary_search
from ..utils.optim import lbfgs_minimize, make_optimizer
from ..utils.validation import check_neighbor_param
from .base import LogAffinity, SparseLogAffinity

_SYNC_EVERY = 8


def _log_Pe(C: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Unnormalized Gaussian log-kernel with per-row bandwidth."""
    return -C / eps[:, None]


def _target_entropy(perplexity: float, dtype) -> float:
    """log(perplexity) + 1, formed in ``dtype`` as the JAX package forms it."""
    return float(torch.log(torch.tensor(perplexity, dtype=dtype)) + 1.0)


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
    target_entropy = _target_entropy(perplexity, C.dtype)

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


def _log_Pse(C, eps, mu, eps_square: bool):
    """SEA log-kernel (mu_i + mu_j - 2 C_ij) / (eps'_i + eps'_j), the
    denominator clamped at 1e-6 as in the JAX package (the dual ascent can
    drive an eps through ~0)."""
    _eps = eps**2 if eps_square else eps
    denom = torch.clamp(_eps[:, None] + _eps[None, :], min=1e-6)
    return (mu[:, None] + mu[None, :] - 2.0 * C) / denom


def sea_dual_value(C, eps, mu, eps_square: bool, target_entropy):
    """Negated SEA dual objective (the scalar the LBFGS branch minimizes):
    D = <P, C> + sum_i eps'_i (target - H_i) + sum_i mu_i (1 - (P 1)_i) at
    P = exp(_log_Pse(C, eps, mu)); its gradient is the first-order dual
    gradient of the Adam branch."""
    _eps = eps**2 if eps_square else eps
    log_P = _log_Pse(C, eps, mu, eps_square)
    P = torch.exp(log_P)
    H = entropy_red(log_P, log=True)
    D = (
        torch.sum(P * C)
        + torch.dot(_eps, target_entropy - H)
        + torch.dot(mu, 1.0 - torch.sum(P, dim=1))
    )
    return -D


def _solve_sea_lbfgs(C, perplexity, eps_square, tol, max_iter):
    """SEA dual solve by :func:`lbfgs_minimize`; gradients by autograd."""
    n = C.shape[0]
    target = _target_entropy(perplexity, C.dtype)

    def value_and_grad(params):
        eps, mu = (p.detach().requires_grad_(True) for p in params)
        with torch.enable_grad():
            f = sea_dual_value(C, eps, mu, eps_square, target)
            g = torch.autograd.grad(f, (eps, mu))
        return f, g

    x0 = (torch.ones((n,), dtype=C.dtype, device=C.device),
          torch.ones((n,), dtype=C.dtype, device=C.device))
    (eps, mu), _, n_iter = lbfgs_minimize(value_and_grad, x0, max_iter=max_iter, tol=tol)
    if not eps_square:
        eps = torch.clamp(eps, min=0.0)
    return _log_Pse(C, eps, mu, eps_square), eps, mu, n_iter


def _solve_sea(C, perplexity, lr, eps_square, tol, max_iter, optimizer="Adam"):
    """Dual ascent on (eps, mu); returns (log_P, eps, mu, n_iter). Stops
    after the first iteration whose dual gradients both have norm < tol."""
    if optimizer == "LBFGS":
        return _solve_sea_lbfgs(C, perplexity, eps_square, tol, max_iter)
    n = C.shape[0]
    target = _target_entropy(perplexity, C.dtype)
    opt = make_optimizer(optimizer)
    # (eps, mu) stacked: the optimizers are elementwise
    params = torch.ones((2, n), dtype=C.dtype, device=C.device)
    state = opt.init(params)
    stopped = torch.zeros((), dtype=torch.bool, device=C.device)
    n_iter = torch.zeros((), dtype=torch.int64, device=C.device)
    for it in range(int(max_iter)):
        if it and it % _SYNC_EVERY == 0 and bool(stopped):
            break
        eps, mu = params
        log_P = _log_Pse(C, eps, mu, eps_square)
        g_eps = entropy_red(log_P, log=True) - target
        if eps_square:
            g_eps = 2.0 * eps * g_eps
        g_mu = torch.exp(torch.logsumexp(log_P, dim=1)) - 1.0
        new, state = opt.update(torch.stack([g_eps, g_mu]), state, params, lr, {})
        if not eps_square:
            new = torch.stack([torch.clamp(new[0], min=0.0), new[1]])
        params = torch.where(stopped, params, new)
        n_iter = n_iter + (~stopped).long()
        done = (torch.linalg.vector_norm(g_eps) < tol) & (torch.linalg.vector_norm(g_mu) < tol)
        stopped = stopped | done
    eps, mu = params
    return _log_Pse(C, eps, mu, eps_square), eps, mu, int(n_iter)


class SymmetricEntropicAffinity(LogAffinity):
    r"""Symmetric entropic affinity (SEA) of Van Assel et al. 2023.

    Dual ascent on :math:`(\varepsilon, \mu)` for the entropy-constrained
    symmetric OT problem. ``optimizer="Adam"`` (default) runs Adam on the
    first-order dual gradients; ``optimizer="LBFGS"`` runs
    :func:`lbfgs_minimize` on the explicit dual objective.
    """

    def __init__(
        self,
        perplexity: float = 30,
        lr: float = 1e-1,
        eps_square: bool = True,
        tol: float = 1e-3,
        max_iter: int = 500,
        optimizer: str = "Adam",
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        **kwargs,
    ):
        super().__init__(
            metric=metric, zero_diag=zero_diag, device=device, verbose=verbose, **kwargs
        )
        self.perplexity = perplexity
        self.lr = lr
        self.eps_square = bool(eps_square)
        self.tol = tol
        self.max_iter = max_iter
        self.optimizer = optimizer

    def _compute_log_affinity(self, X: torch.Tensor):
        n = X.shape[0]
        perplexity = check_neighbor_param(self.perplexity, n, logger=self.logger)
        C = self._distance_matrix(X)
        log_P, eps, mu, n_iter = _solve_sea(
            C,
            float(perplexity),
            lr=float(self.lr),
            eps_square=self.eps_square,
            tol=float(self.tol),
            max_iter=int(self.max_iter),
            optimizer=self.optimizer,
        )
        self.eps_ = eps
        self.mu_ = mu
        self.n_iter_ = int(n_iter)
        return log_P - math.log(n)


def sinkhorn_log(log_K, dual0, tol, max_iter, with_grad: bool = False):
    """Symmetric log-domain Sinkhorn, f <- (f + T(f)) / 2; returns
    (log_P, dual) with log_P = f_i + f_j + log_K.

    With ``with_grad`` it runs exactly ``max_iter`` differentiable
    iterations; otherwise the dual is computed without gradients and stops
    after the first iteration with ||f - T(f)|| < tol, and the gradient of
    log_P flows through log_K only.
    """

    def half_step(f, lk):
        return 0.5 * (f - torch.logsumexp(lk + f[:, None], dim=0))

    if with_grad:
        dual = dual0
        for _ in range(int(max_iter)):
            dual = half_step(dual, log_K)
    else:
        with torch.no_grad():
            lk = log_K.detach()
            dual = dual0.detach()
            stopped = torch.zeros((), dtype=torch.bool, device=lk.device)
            for it in range(int(max_iter)):
                if it and it % _SYNC_EVERY == 0 and bool(stopped):
                    break
                new = half_step(dual, lk)
                delta = torch.linalg.vector_norm(2.0 * (new - dual))
                dual = torch.where(stopped, dual, new)
                stopped = stopped | (delta < tol)
    return dual[:, None] + dual[None, :] + log_K, dual


class SinkhornAffinity(LogAffinity):
    r"""Symmetric doubly stochastic affinity by log-domain Sinkhorn.

    ``with_grad=True`` differentiates through the fixed iterations
    (TSNEkhorn's unrolling); otherwise the dual is computed without
    gradients.
    """

    def __init__(
        self,
        eps: float = 1.0,
        tol: float = 1e-5,
        max_iter: int = 1000,
        base_kernel: str = "gaussian",
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        with_grad: bool = False,
        **kwargs,
    ):
        super().__init__(
            metric=metric, zero_diag=zero_diag, device=device, verbose=verbose, **kwargs
        )
        self.eps = eps
        self.tol = tol
        self.max_iter = max_iter
        self.base_kernel = base_kernel
        self.with_grad = with_grad

    def _compute_log_affinity(self, X: torch.Tensor, init_dual: Optional[torch.Tensor] = None):
        C = self._distance_matrix(X)
        return self.from_cost(C, init_dual=init_dual)

    def from_cost(self, C: torch.Tensor, init_dual: Optional[torch.Tensor] = None):
        """Run Sinkhorn directly on a cost matrix."""
        n = C.shape[0]
        if self.base_kernel == "student":
            C = torch.log1p(C)
        log_K = -C / self.eps
        if init_dual is None:
            init_dual = torch.zeros((n,), dtype=C.dtype, device=C.device)
        log_P, dual = sinkhorn_log(
            log_K, init_dual, tol=float(self.tol), max_iter=int(self.max_iter),
            with_grad=self.with_grad,
        )
        self.dual_ = dual
        return log_P - math.log(n)


class NormalizedGaussianAffinity(LogAffinity):
    r"""Gaussian affinity exp(-C/σ), optionally normalized along
    ``normalization_dim`` (an int: rows or columns, then divided by n; a
    tuple: the whole matrix; None: unnormalized)."""

    def __init__(
        self,
        sigma: float = 1.0,
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        normalization_dim: Union[int, Tuple[int, ...], None] = (0, 1),
        **kwargs,
    ):
        super().__init__(
            metric=metric, zero_diag=zero_diag, device=device, verbose=verbose, **kwargs
        )
        self.sigma = sigma
        self.normalization_dim = normalization_dim

    def _compute_log_affinity(self, X: torch.Tensor):
        C = self._distance_matrix(X)
        return self._normalize(-C / self.sigma, X.shape[0])

    def _normalize(self, log_aff, n):
        if self.normalization_dim is not None:
            log_aff = log_aff - torch.logsumexp(log_aff, dim=self.normalization_dim, keepdim=True)
        if isinstance(self.normalization_dim, int):
            log_aff = log_aff - math.log(n)
        return log_aff


class NormalizedStudentAffinity(NormalizedGaussianAffinity):
    r"""Student-t affinity (1 + C/ν)^{-(ν+1)/2}, optionally normalized."""

    def __init__(
        self,
        degrees_of_freedom: float = 1.0,
        metric: str = "sqeuclidean",
        zero_diag: bool = True,
        device: str = "auto",
        verbose: bool = False,
        normalization_dim: Union[int, Tuple[int, ...], None] = (0, 1),
        **kwargs,
    ):
        super().__init__(
            sigma=1.0,
            metric=metric,
            zero_diag=zero_diag,
            device=device,
            verbose=verbose,
            normalization_dim=normalization_dim,
            **kwargs,
        )
        self.degrees_of_freedom = degrees_of_freedom

    def _compute_log_affinity(self, X: torch.Tensor):
        C = self._distance_matrix(X)
        nu = self.degrees_of_freedom
        return self._normalize(-0.5 * (nu + 1.0) * torch.log1p(C / nu), X.shape[0])
