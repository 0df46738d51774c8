"""Losses, reductions and small linear-algebra helpers.

Counterpart of the parts of ``torchdr_tpu/ops/reductions.py`` that the
ported paths reach: the cross-entropy and square losses, the row entropy, the
(masked) logsumexp and sum reductions, the SVD sign convention and
k-smallest/largest selection. The O(n²) streaming reductions live in
``ops/reduce.py``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Dim = Union[int, Tuple[int, ...], None]


def cross_entropy_loss(P: torch.Tensor, Q: torch.Tensor, log: bool = False) -> torch.Tensor:
    """H(P, Q) = -sum(P * log Q); with ``log=True`` Q holds log-probabilities."""
    if log:
        return -torch.sum(P * Q)
    return -torch.sum(P * torch.log(Q))


def square_loss(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """sum((P - Q)²)."""
    return torch.sum((P - Q) ** 2)


def entropy(P: torch.Tensor, log: bool = True, dim: int = 1) -> torch.Tensor:
    """Row-wise Shannon entropy h(p) = -sum p (log p - 1)."""
    if log:
        return -torch.sum(torch.exp(P) * (P - 1.0), dim=dim)
    return -torch.sum(P * (torch.log(P) - 1.0), dim=dim)


def _dims(dim: Dim, ndim: int):
    return tuple(range(ndim)) if dim is None else dim


def logsumexp_red(logP: torch.Tensor, dim: Dim = 1, keepdims: bool = True) -> torch.Tensor:
    """logsumexp reduction; keepdims so results broadcast against (n, k) arrays."""
    return torch.logsumexp(logP, dim=_dims(dim, logP.ndim), keepdim=keepdims)


def sum_red(P: torch.Tensor, dim: Dim = 1, keepdims: bool = True) -> torch.Tensor:
    return torch.sum(P, dim=_dims(dim, P.ndim), keepdim=keepdims)


def masked_logsumexp(
    logP: torch.Tensor, mask: torch.Tensor, dim: Dim = 1, keepdims: bool = True
) -> torch.Tensor:
    """logsumexp over the entries where ``mask`` holds (padded (n, k)
    affinities pass ``mask = indices >= 0``)."""
    neg_inf = torch.full_like(logP, float("-inf"))
    return logsumexp_red(torch.where(mask, logP, neg_inf), dim=dim, keepdims=keepdims)


def svd_flip(u: torch.Tensor, v: torch.Tensor, u_based_decision: bool = True):
    """Deterministic SVD signs: the largest-|.| entry of each u column (or v
    row) is made positive."""
    if u_based_decision:
        max_abs = torch.argmax(torch.abs(u), dim=0)
        signs = torch.sign(u[max_abs, torch.arange(u.shape[1], device=u.device)])
    else:
        max_abs = torch.argmax(torch.abs(v), dim=1)
        signs = torch.sign(v[torch.arange(v.shape[0], device=v.device), max_abs])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return u * signs[None, :], v * signs[:, None]


def svd(A: torch.Tensor, full_matrices: bool = False):
    """``torch.linalg.svd``, with cuSOLVER's QR-based ``gesvd`` on the card.
    Its default there, the Jacobi ``gesvdj``, returned an incremental PCA
    update of 3,972 × 784 with V orthonormal to 4.3e-4 only and singular
    values 7.7e-5 off; ``gesvd`` to 1.7e-6 and 8e-7, as LAPACK's on the CPU
    (``chip_smoke.py``'s spectral phase measures both)."""
    return torch.linalg.svd(A, full_matrices=full_matrices,
                            driver="gesvd" if A.is_cuda else None)


def center_kernel(K: torch.Tensor) -> torch.Tensor:
    """Double-centre a kernel matrix: K - row means - column means + mean."""
    row_mean = torch.mean(K, dim=1, keepdim=True)
    col_mean = torch.mean(K, dim=0, keepdim=True)
    return K - row_mean - col_mean + torch.mean(K)


def matrix_power(A: torch.Tensor, p: Union[int, float]) -> torch.Tensor:
    """A^p: integer powers by repeated squaring, with the products in the
    order ``jnp.linalg.matrix_power`` takes them (``torch.linalg.matrix_power``
    orders them otherwise, which rounds differently in float32);
    fractional powers through ``eigh`` of the symmetric part, negative
    eigenvalues clamped to 0."""
    if isinstance(p, int) or (isinstance(p, float) and p.is_integer()):
        n = int(p)
        if n == 0:
            return torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        if n < 0:
            A, n = torch.linalg.inv(A), -n
        if n == 3:
            return (A @ A) @ A
        z = result = None
        while n > 0:
            z = A if z is None else z @ z
            n, bit = divmod(n, 2)
            if bit:
                result = z if result is None else result @ z
        return result
    # jnp.linalg.eigh symmetrizes its input; torch's reads one triangle
    evals, evecs = torch.linalg.eigh(0.5 * (A + A.T))
    evals = torch.clamp(evals, min=0.0)
    return (evecs * (evals**p)[None, :]) @ evecs.T


def check_nonnegativity_eigenvalues(evals: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Clamp negative eigenvalues above -tol (numerical noise) to zero."""
    return torch.where((evals < 0) & (evals > -tol), torch.zeros_like(evals), evals)


def kmin(C: torch.Tensor, k: int, dim: int = 1):
    """k smallest values (ascending) and their int32 indices along ``dim``."""
    v, i = torch.topk(C, k, dim=dim, largest=False, sorted=True)
    return v, i.to(torch.int32)


def kmax(C: torch.Tensor, k: int, dim: int = 1):
    """k largest values (descending) and their int32 indices along ``dim``."""
    v, i = torch.topk(C, k, dim=dim, largest=True, sorted=True)
    return v, i.to(torch.int32)
