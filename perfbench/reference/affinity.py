"""UMAP's fuzzy affinity and t-SNE's perplexity-calibrated affinity.

Both start from each row's k nearest neighbours (ascending squared
distances D and their ids) and calibrate each row by a bisection on the log
of its bandwidth, run for a fixed 200 halvings, which leaves the float64
bandwidth exact to its last bits.

- UMAP (McInnes et al. 2018): ρ_i the nearest distance, σ_i such that
  Σ_j exp(-(D_ij - ρ_i)/σ_i) = log2(k), memberships A_ij = exp(-(D_ij -
  ρ_i)/σ_i), then the fuzzy union P = A + Aᵀ - A∘Aᵀ over the graph, each row
  kept to its ``k_out`` strongest entries (equal values by column).
- t-SNE (van der Maaten & Hinton 2008): ε_i such that the entropy of
  p_·|i = softmax(-D_i/ε_i) is log(perplexity); P_ij = p_j|i / n over the
  row's neighbours (the loss is symmetric in i and j, so P needs no union).

A sparse matrix is a pair (keys, values): keys = row · n + column, sorted.
"""

from __future__ import annotations

import math

import torch

_HALVINGS = 200


def _bisect_log(gap, rows: int, dtype, device, lo: float = -80.0, hi: float = 80.0):
    """exp of the root in [lo, hi] of the increasing row-wise ``gap(log s)``."""
    lo = torch.full((rows,), lo, dtype=dtype, device=device)
    hi = torch.full((rows,), hi, dtype=dtype, device=device)
    for _ in range(_HALVINGS):
        mid = 0.5 * (lo + hi)
        below = gap(mid) < 0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return torch.exp(0.5 * (lo + hi))


def umap_memberships(D: torch.Tensor, n_neighbors: int) -> torch.Tensor:
    """The directed memberships A (n, k) of each row's neighbours (an
    infinite distance, a missing neighbour, gets 0)."""
    shifted = D - D.min(dim=1, keepdim=True).values
    target = math.log2(n_neighbors)

    def gap(log_s):
        return torch.exp(-shifted / torch.exp(log_s)[:, None]).sum(1) - target

    sigma = _bisect_log(gap, D.shape[0], D.dtype, D.device)
    return torch.exp(-shifted / sigma[:, None])


def fuzzy_union(A: torch.Tensor, ids: torch.Tensor, k_out: int):
    """(keys, P) of A + Aᵀ - A∘Aᵀ, each row cut to its ``k_out`` strongest."""
    n, k = A.shape
    rows = torch.arange(n, device=A.device).repeat_interleave(k)
    cols = ids.reshape(-1).long()
    v = A.reshape(-1)
    edge = cols >= 0
    rows, cols, v = rows[edge], cols[edge], v[edge]
    keys, inverse = torch.unique(torch.cat([rows * n + cols, cols * n + rows]),
                                 sorted=True, return_inverse=True)
    out = torch.zeros(keys.shape[0], dtype=A.dtype, device=A.device)
    back = torch.zeros_like(out)
    out.index_add_(0, inverse[: v.shape[0]], v)
    back.index_add_(0, inverse[v.shape[0]:], v)
    P = out + back - out * back
    # rank each entry within its row by value (descending, equal values by column)
    row = keys // n
    by_value = torch.argsort(-P, stable=True)
    order = by_value[torch.argsort(row[by_value], stable=True)]
    counts = torch.bincount(row, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=A.device) - start[row[order]]
    keep = rank < k_out
    return keys[keep], P[keep]


def entropic_rows(D: torch.Tensor, perplexity: float) -> torch.Tensor:
    """p_·|i / n (n, k) over each row's neighbours, entropy log(perplexity)."""
    n = D.shape[0]
    shifted = D - D.min(dim=1, keepdim=True).values
    target = math.log(perplexity)

    def gap(log_e):
        logp = torch.log_softmax(-shifted / torch.exp(log_e)[:, None], dim=1)
        return -(logp.exp() * logp).sum(1) - target

    eps = _bisect_log(gap, n, D.dtype, D.device)
    return torch.softmax(-shifted / eps[:, None], dim=1) / n


def lookup(keys: torch.Tensor, values: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """values at the sorted ``keys`` equal to ``query``, 0 where none is."""
    pos = torch.searchsorted(keys, query).clamp(max=max(keys.shape[0] - 1, 0))
    hit = keys[pos] == query
    return torch.where(hit, values[pos], torch.zeros((), dtype=values.dtype, device=values.device))


def rows_of(keys: torch.Tensor, values: torch.Tensor, rows: torch.Tensor, n: int):
    """(row position in ``rows``, key, value) of every entry of those rows."""
    lo = torch.searchsorted(keys, rows.long() * n)
    hi = torch.searchsorted(keys, (rows.long() + 1) * n)
    counts = hi - lo
    which = torch.arange(rows.shape[0], device=keys.device).repeat_interleave(counts)
    offset = torch.arange(which.shape[0], device=keys.device) - (
        torch.cumsum(counts, 0) - counts)[which]
    at = lo[which] + offset
    return which, keys[at], values[at]


def padded_rows(n: int, rows: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor):
    """(row position, key, value) of the entries of padded (m, W) rows of
    ``rows`` (ids < 0 are padding)."""
    valid = ids >= 0
    which = torch.arange(rows.shape[0], device=rows.device)[:, None].expand_as(ids)[valid]
    keys = rows.long()[:, None].expand_as(ids)[valid] * n + ids[valid].long()
    return which, keys, vals[valid]


def row_gaps(n: int, rows: torch.Tensor, got, ref_keys: torch.Tensor,
             ref_vals: torch.Tensor) -> torch.Tensor:
    """For each row of ``rows``: the widest gap between the entries ``got``
    ((row position, key, value), as :func:`rows_of` gives them) and the
    reference's entries of that row, over the union of their columns, as a
    share of the reference row's largest value. A column one side lacks
    counts at the other side's value."""
    m = rows.shape[0]
    which_got, got_keys, got_v = got
    got_v = got_v.to(ref_vals.dtype)
    gap = torch.zeros(m, dtype=ref_vals.dtype, device=rows.device)
    gap.scatter_reduce_(0, which_got, (got_v - lookup(ref_keys, ref_vals, got_keys)).abs(),
                        reduce="amax")
    which_ref, keys_ref, vals_ref = rows_of(ref_keys, ref_vals, rows, n)
    order = torch.argsort(got_keys)
    missing = torch.where(lookup(got_keys[order], torch.ones_like(got_v), keys_ref) > 0,
                          torch.zeros_like(vals_ref), vals_ref)
    gap.scatter_reduce_(0, which_ref, missing, reduce="amax")
    top = torch.zeros_like(gap).scatter_reduce_(0, which_ref, vals_ref, reduce="amax")
    return gap / top.clamp(min=torch.finfo(top.dtype).tiny)


def directed_keys(ids: torch.Tensor, values: torch.Tensor):
    """(keys, values) of a directed (n, k) neighbour matrix, sorted."""
    n, k = ids.shape
    keys = torch.arange(n, device=ids.device).repeat_interleave(k) * n + ids.reshape(-1).long()
    order = torch.argsort(keys)
    return keys[order], values.reshape(-1)[order]
