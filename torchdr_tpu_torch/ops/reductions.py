"""Losses, reductions and small linear-algebra helpers.

Counterpart of the parts of ``torchdr_tpu/ops/reductions.py`` that the
ported paths reach: the cross-entropy loss, the row entropy, the
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


def kmin(C: torch.Tensor, k: int, dim: int = 1):
    """k smallest values (ascending) and their int32 indices along ``dim``."""
    v, i = torch.topk(C, k, dim=dim, largest=False, sorted=True)
    return v, i.to(torch.int32)


def kmax(C: torch.Tensor, k: int, dim: int = 1):
    """k largest values (descending) and their int32 indices along ``dim``."""
    v, i = torch.topk(C, k, dim=dim, largest=True, sorted=True)
    return v, i.to(torch.int32)
