"""LOBPCG for the top-k eigenpairs of a symmetric operator.

The port's own copy of ``jax.experimental.sparse.linalg.lobpcg_standard``
(JAX, Apache License 2.0), which ``torchdr_tpu/models/spectral/kernel_pca.py``
calls with a callable matvec. ``torch.lobpcg`` takes a tensor, not an
operator, and runs another iteration, so the JAX algorithm is carried over
step for step: the same orthonormalization (SVQB, twice), the same residual
projection, Rayleigh-Ritz, search directions, and the stop test
``|r| < tol · 10 · n · (|AX| + θ)`` for every pair, with ``tol`` the dtype's
epsilon and at most ``m`` iterations. Every product runs in the inputs'
dtype (float32 with TF32 off, as the package sets it).

The JAX loop is one ``lax.while_loop`` that tests its stop condition every
iteration. Here the condition stays on the device: once it holds, later
iterations still run but their updates are masked out (``torch.where``), and
the host reads the flag every ``sync_every`` iterations. The result and the
iteration count are those of testing every iteration.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..ops.reductions import svd

_SYNC_EVERY = 8


def _norms(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(X, ord=2, dim=0, keepdim=True)


def _eigh_descending(A: torch.Tensor):
    w, V = torch.linalg.eigh(A)
    return torch.flip(w, (0,)), torch.flip(V, (1,))


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis of span(X) from the eigenbasis of XᵀX, with the
    columns of numerically degenerate directions set to 0."""
    norms = _norms(X)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** (-0.5)
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _norms(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, torch.ones_like(norms))


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The part of U orthogonal to the orthonormal ``basis``, orthonormalized;
    columns that may still hold a part of the basis are set to 0."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    return U * (_norms(U) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A: Callable, S: torch.Tensor):
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """m directions orthonormal to X and to each other, by a block
    Householder reflector (deterministic, no random draw)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = svd(Xupper, full_matrices=True)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat(
        [torch.eye(m, dtype=X.dtype, device=X.device),
         torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] += other
    return h


def _check_inputs(A: Callable, X: torch.Tensor) -> None:
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were {test_output.dtype}, {X.dtype})")
    if test_output.shape != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output {tuple(test_output.shape)}")


def lobpcg_standard(
    A: Union[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]],
    X0: torch.Tensor,
    m: int = 200,
    tol: Optional[float] = None,
    sync_every: int = _SYNC_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The k largest eigenpairs of the symmetric positive definite operator
    ``A`` (a callable on (n, k) tensors, or an (n, n) tensor), from the
    start ``X0`` (n, k) with 5k < n. Returns ``(theta, X, iterations)``:
    the eigenvalues (k,) in descending order, the eigenvectors (n, k) and
    the number of iterations run, as the JAX function returns them."""
    if isinstance(A, torch.Tensor):
        A = A.__matmul__
    n, k = X0.shape
    _check_inputs(A, X0)
    if tol is None:
        tol = float(torch.finfo(X0.dtype).eps)

    X = _orthonormalize(X0)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0)
    R = AX - theta[None, :] * X

    # the JAX loop's condition `converged < k` on the device: True while the
    # next iteration's update is taken
    active = torch.ones((), dtype=torch.bool, device=X0.device)
    iterations = torch.zeros((), dtype=torch.int64, device=X0.device)
    for i in range(m):
        if i % sync_every == 0 and not bool(active):
            break
        R_new = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R_new), dim=1)
        theta_new, Q = _rayleigh_ritz_orth(A, XPR)

        B = Q[:, :k]
        B = B / _norms(B)
        X_new = XPR @ B
        X_new = X_new / _norms(X_new)

        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P_new = XPR @ (Q[:, k:] @ q)
        normP = _norms(P_new)
        P_new = P_new / torch.where(normP == 0, torch.ones_like(normP), normP)

        AX = A(X_new)
        theta_new = theta_new[:k]
        R_next = AX - theta_new[None, :] * X_new
        resid_norms = torch.linalg.vector_norm(R_next, ord=2, dim=0)
        reltol = (torch.linalg.vector_norm(AX, ord=2, dim=0) + theta_new) * n * 10
        converged = torch.sum(resid_norms < tol * reltol)

        X = torch.where(active, X_new, X)
        P = torch.where(active, P_new, P)
        R = torch.where(active, R_next, R)
        theta = torch.where(active, theta_new, theta)
        iterations = iterations + active.to(torch.int64)
        active = active & (converged < k)
    return theta, X, int(iterations)
