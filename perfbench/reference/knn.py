"""Exact nearest neighbours under the squared euclidean distance.

:func:`neighbours_of_rows` takes each distance from the float64 differences
(no product, so nothing a TF32 setting could touch): the yardstick of the
kNN graph's recall. :func:`all_neighbours` gives every row's neighbours for
the affinities, from a float64 product of centred rows (its rounding, about
1e-16 of a squared norm, lies far below the float32 program's), or, as the
control, from a TF32 product. Each row's own id is left out. Ties, which
continuous data does not produce, go to the lower id.
"""

from __future__ import annotations

import torch

from .precision import CONTROL, REFERENCE, check_mode, tf32_round


def _topk(D: torch.Tensor, k: int):
    d, i = torch.topk(D, k, dim=1, largest=False, sorted=True)
    return d, i


def neighbours_of_rows(X: torch.Tensor, rows: torch.Tensor, k: int, block: int = 128):
    """(dists, ids) of the k nearest other rows of X for each row in
    ``rows``, from float64 differences. X lies on the device that computes."""
    Xd = X.double()
    out_d, out_i = [], []
    for r0 in range(0, rows.shape[0], block):
        r = rows[r0:r0 + block]
        D = torch.cdist(Xd[r], Xd, compute_mode="donot_use_mm_for_euclid_dist") ** 2
        D[torch.arange(r.shape[0], device=D.device), r] = float("inf")
        d, i = _topk(D, k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def all_neighbours(X: torch.Tensor, k: int, mode: str = REFERENCE, block: int = 2048,
                   rows: torch.Tensor | None = None):
    """(dists, ids) of the k nearest other rows of every row of X (or of
    ``rows``): float64 product of the centred rows, or in ``CONTROL`` mode
    the float32 norms and a TF32 product, as a TF32 gram computes them."""
    check_mode(mode)
    if mode == CONTROL:
        Xc = X.float() - X.float().mean(0, keepdim=True)
        Xp = tf32_round(Xc)
    else:
        Xc = X.double() - X.double().mean(0, keepdim=True)
        Xp = Xc
    sq = (Xc * Xc).sum(1)
    if rows is None:
        rows = torch.arange(X.shape[0], device=X.device)
    out_d, out_i = [], []
    for r0 in range(0, rows.shape[0], block):
        r = rows[r0:r0 + block]
        D = sq[r, None] + sq[None, :] - 2.0 * (Xp[r] @ Xp.T)
        D[torch.arange(r.shape[0], device=D.device), r] = float("inf")
        d, i = _topk(D.clamp_(min=0.0), k)
        out_d.append(d.double())
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def edge_distances(X: torch.Tensor, ids: torch.Tensor, mode: str = REFERENCE,
                   block: int = 65_536) -> torch.Tensor:
    """(n, k) squared distances of the given edges (ids < 0 give inf): float64
    differences, or in ``CONTROL`` mode a TF32 product of the centred rows."""
    check_mode(mode)
    if mode == CONTROL:
        Xc = X.float() - X.float().mean(0, keepdim=True)
        Xp, sq = tf32_round(Xc), (Xc * Xc).sum(1)
    else:
        Xc = X.double()
    out = torch.empty(ids.shape, dtype=torch.float64, device=X.device)
    for r0 in range(0, ids.shape[0], block):
        j = ids[r0:r0 + block].long().clamp(min=0)
        if mode == CONTROL:
            r = torch.arange(r0, r0 + j.shape[0], device=X.device)
            D = sq[r, None] + sq[j] - 2.0 * (Xp[r][:, None, :] * Xp[j]).sum(-1)
        else:
            D = ((Xc[r0:r0 + block][:, None, :] - Xc[j]) ** 2).sum(-1)
        out[r0:r0 + block] = D.double().clamp(min=0.0)
    return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))
