"""Small reductions and linear-algebra helpers.

Counterpart of the parts of ``torchdr_tpu/ops/reductions.py`` that the UMAP
path reaches: the SVD sign convention and k-smallest/largest selection.
"""

from __future__ import annotations

import torch


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
    """k smallest values (ascending) and their indices along ``dim``."""
    return torch.topk(C, k, dim=dim, largest=False, sorted=True)


def kmax(C: torch.Tensor, k: int, dim: int = 1):
    """k largest values (descending) and their indices along ``dim``."""
    return torch.topk(C, k, dim=dim, largest=True, sorted=True)
