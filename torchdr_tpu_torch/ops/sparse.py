"""Padded sparse utilities (counterpart of ``torchdr_tpu/ops/sparse.py``).

Sparse affinities are stored as padded ``(n, k)`` value/index pairs;
padding slots carry index ``-1`` and value ``0``.

The JAX package symmetrizes with static shapes only (one multi-operand sort
of the 2nk edge list, merge of adjacent duplicates, scatter into a fixed
width). PyTorch allows data-dependent shapes, so the port drops the padding
edges up front, merges the two directions of each edge with
``torch.unique`` on an int64 (row, col) key, and packs rows with a scatter.
The packing order matches the JAX package: column order within a row, or
strongest value first when ``k_out`` caps a row.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

#: auto-k_out memory guard: ~256M entries ≈ 1 GB f32 + 1 GB index output
_AUTO_KOUT_BUDGET_ENTRIES = 256 * 1024 * 1024


def symmetric_degrees(indices: torch.Tensor) -> torch.Tensor:
    """Upper bound on per-row nnz of P + Pᵀ: own out-degree + in-degree."""
    n = indices.shape[0]
    valid = indices >= 0
    out_deg = valid.sum(dim=1)
    in_deg = torch.bincount(indices[valid].long(), minlength=n)[:n]
    return out_deg + in_deg


def resolve_k_out(indices: torch.Tensor, k_out: int | None) -> Tuple[int, bool]:
    """(k_out, value_order) of a symmetrization: without ``k_out`` the max
    symmetric degree rounded up to a multiple of 8 (one host read), capped at
    a memory budget; ``value_order`` when rows may hold more edges than
    ``k_out``, which then keep their strongest."""
    n = indices.shape[0]
    max_deg = int(symmetric_degrees(indices).max())
    if k_out is None:
        k_out = max(8, -(-max_deg // 8) * 8)
        cap = max(8, (_AUTO_KOUT_BUDGET_ENTRIES // max(1, n)) // 8 * 8)
        if k_out > cap:
            warnings.warn(
                f"[TorchDR-Torch] symmetric degree {max_deg} exceeds the auto "
                f"width budget at n={n}; capping k_out at {cap} (weakest hub "
                "edges dropped). Pass k_out to override."
            )
            k_out = cap
    return k_out, k_out < max_deg


def pack_rows(u_row, u_col, v_comb, rows: int, k_out: int, value_order: bool, dtypes):
    """Merged edges (``u_row``, ``u_col`` sorted by (row, column)) packed
    into ``(rows, k_out)`` values and indices, padded 0 / −1: column order
    within a row, or strongest first (equal values in column order) under
    ``value_order``."""
    device = v_comb.device
    if value_order:
        order = torch.argsort(-v_comb, stable=True)
        order = order[torch.argsort(u_row[order], stable=True)]
        u_row, u_col, v_comb = u_row[order], u_col[order], v_comb[order]
    counts = torch.bincount(u_row, minlength=rows)
    row_start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(u_row.shape[0], device=device) - row_start[u_row]
    keep = slot < k_out
    out_vals = torch.zeros((rows, k_out), dtype=dtypes[0], device=device)
    out_idx = torch.full((rows, k_out), -1, dtype=dtypes[1], device=device)
    out_vals[u_row[keep], slot[keep]] = v_comb[keep]
    out_idx[u_row[keep], slot[keep]] = u_col[keep].to(dtypes[1])
    return out_vals, out_idx


def symmetrize_sparse(
    values: torch.Tensor,
    indices: torch.Tensor,
    mode: str = "sum_minus_prod",
    k_out: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetrize a padded sparse matrix P.

    - ``mode="sum"``: Q = P + Pᵀ
    - ``mode="sum_minus_prod"``: Q = P + Pᵀ - P∘Pᵀ (UMAP fuzzy union)

    Without ``k_out`` the output width is the max symmetric degree rounded
    up to a multiple of 8 (one host read), capped at a memory budget. Rows
    wider than ``k_out`` keep their strongest edges.

    Returns (values_out, indices_out) of shape (n, k_out), padded 0 / -1.
    """
    if mode not in ("sum", "sum_minus_prod"):
        raise ValueError(f"Unsupported mode {mode!r}")
    n, k = values.shape
    k_out, value_order = resolve_k_out(indices, k_out)
    device = values.device

    rows = torch.arange(n, device=device).repeat_interleave(k)
    cols = indices.reshape(-1).long()
    v = values.reshape(-1)
    valid = cols >= 0
    r, c, v = rows[valid], cols[valid], v[valid]

    # both directions of every edge, merged on the (row, col) key
    key = torch.cat([r * n + c, c * n + r])
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    n_p = r.shape[0]
    vP = torch.zeros(uniq.shape[0], dtype=values.dtype, device=device)
    vPT = torch.zeros_like(vP)
    vP.index_add_(0, inv[:n_p], v)
    vPT.index_add_(0, inv[n_p:], v)
    v_comb = vP + vPT if mode == "sum" else vP + vPT - vP * vPT
    return pack_rows(uniq // n, uniq % n, v_comb, n, k_out, value_order,
                     (values.dtype, indices.dtype))


def sparse_to_dense(values: torch.Tensor, indices: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Densify a padded sparse matrix (tests / small-n paths)."""
    n, k = values.shape
    rows = torch.arange(n, device=values.device)[:, None].expand(n, k)
    valid = indices >= 0
    dense = torch.zeros((n, n_cols), dtype=values.dtype, device=values.device)
    return dense.index_put_(
        (rows, torch.clamp(indices, min=0).long()),
        torch.where(valid, values, torch.zeros_like(values)),
        accumulate=True,
    )
