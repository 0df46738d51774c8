"""Pairwise distance and kNN-graph primitives.

Counterpart of ``torchdr_tpu/ops/distance.py``:

- :func:`pairwise_distances` — dense distances, optional top-k selection.
- :func:`pairwise_distances_indexed` — distances to indexed keys.
- :func:`knn_graph` — exact kNN over row blocks (O(block · m) memory), one
  float32 matrix product and one ``torch.topk`` per block, with a running
  top-k merge over column chunks for large databases.
- :func:`knn_graph_host_chunked` — :func:`knn_graph` called on slices of
  the queries, with the same results.

Self-exclusion adds ``MASK_VALUE`` on the diagonal, as the JAX package does.
Every index output is int32, as ``lax.top_k`` returns it; callers widen
with ``.long()`` where torch needs int64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .metrics import MASK_VALUE, check_metric, indexed_block, pairwise_block


def pairwise_distances(
    X: torch.Tensor,
    Y: Optional[torch.Tensor] = None,
    metric: str = "sqeuclidean",
    k: Optional[int] = None,
    exclude_diag: bool = False,
):
    """Dense pairwise distances, optionally reduced to the k smallest per row.

    Returns ``(C, indices)`` where ``indices`` (int32) is None when ``k``
    is None.
    """
    check_metric(metric)
    self_mode = Y is None
    C = pairwise_block(X, X if self_mode else Y, metric)
    if exclude_diag and self_mode:
        C = C + MASK_VALUE * torch.eye(C.shape[0], dtype=C.dtype, device=C.device)
    if k is None:
        return C, None
    d, i = torch.topk(C, k, dim=1, largest=False, sorted=True)
    return d, i.to(torch.int32)


def pairwise_distances_indexed(
    X: torch.Tensor,
    query_indices: Optional[torch.Tensor] = None,
    key_indices: Optional[torch.Tensor] = None,
    Y: Optional[torch.Tensor] = None,
    metric: str = "sqeuclidean",
) -> torch.Tensor:
    """Distances between indexed subsets of X / Y.

    - ``key_indices`` 2D ``(n_q, k)``: per-query keys, returns ``(n_q, k)``;
      negative (padding) ids are clamped to 0 for the gather, and the caller
      masks those entries.
    - ``key_indices`` 1D: shared keys for all queries, ``(n_q, len)``.
    - ``key_indices`` None: all rows of Y (or X) are keys.
    """
    if Y is None:
        Y = X
    Xq = X if query_indices is None else X[query_indices]
    if key_indices is None:
        return pairwise_block(Xq, Y, metric)
    if key_indices.ndim == 1:
        return pairwise_block(Xq, Y[key_indices], metric)
    if key_indices.ndim != 2:
        raise ValueError(f"key_indices must be 1D or 2D, got {key_indices.ndim}D")
    Yk = Y[torch.clamp(key_indices, min=0).long()]  # (n_q, k, d)
    return indexed_block(Xq, Yk, metric)


def _mask_self(C: torch.Tensor, row0: int, col0: int) -> None:
    """In place: add MASK_VALUE where global row id == global column id."""
    b, m = C.shape
    lo, hi = max(row0, col0), min(row0 + b, col0 + m)
    if lo < hi:
        ids = torch.arange(lo, hi, device=C.device)
        C[ids - row0, ids - col0] += MASK_VALUE


def knn_graph(
    X: torch.Tensor,
    Y: Optional[torch.Tensor] = None,
    k: int = 15,
    metric: str = "sqeuclidean",
    exclude_diag: bool = True,
    block_size: int = 1024,
    precision: str = "highest",
    mode: str = "exact",
    recall_target: float = 0.95,
    db_block: int = 65_536,
    row_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN graph: for each row of X, the k nearest rows of Y (or X).

    ``row_offset`` says that X's row i is Y's row ``row_offset + i`` (a
    row shard of Y, ``parallel/knn``): ``exclude_diag`` then masks that
    column, as it masks the diagonal when Y is None.

    Query rows go in blocks of ``block_size``; each block is one float32
    product followed by ``torch.topk``. Databases wider than ``db_block``
    columns are scanned in column chunks with a running top-k merge, so
    every live buffer stays ≤ block · db_block.

    ``mode="approx"`` is the JAX package's ``lax.approx_min_k`` tier, which
    has no torch counterpart: the port maps it to the exact tier (100%
    recall). ``precision`` and ``recall_target`` are accepted for parity and
    unused. Returns ``(dists, indices)`` of shape ``(n, k)``, ascending;
    the indices are int32, as the JAX package returns them (callers widen
    them where torch needs int64).
    """
    check_metric(metric)
    if mode not in ("exact", "approx"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown knn mode {mode!r}.")
    self_mode = Y is None
    Yc = X if self_mode else Y
    n, m = X.shape[0], Yc.shape[0]
    block = min(block_size, max(8, n))
    mask_self = exclude_diag and (self_mode or row_offset is not None)
    off = int(row_offset or 0)

    dists = torch.empty((n, k), dtype=X.dtype, device=X.device)
    indices = torch.empty((n, k), dtype=torch.int32, device=X.device)
    for r0 in range(0, n, block):
        Xb = X[r0 : r0 + block]
        if m <= db_block:
            C = pairwise_block(Xb, Yc, metric, precision)
            if mask_self:
                _mask_self(C, off + r0, 0)
            d, i = torch.topk(C, k, dim=1, largest=False, sorted=True)
        else:
            d = torch.full((Xb.shape[0], k), MASK_VALUE, dtype=X.dtype, device=X.device)
            i = torch.full((Xb.shape[0], k), -1, dtype=torch.int64, device=X.device)
            for c0 in range(0, m, db_block):
                C = pairwise_block(Xb, Yc[c0 : c0 + db_block], metric, precision)
                if mask_self:
                    _mask_self(C, off + r0, c0)
                dc, ic = torch.topk(
                    C, min(k, C.shape[1]), dim=1, largest=False, sorted=True
                )
                cand_d = torch.cat([d, dc], dim=1)
                cand_i = torch.cat([i, ic + c0], dim=1)
                d, sel = torch.topk(cand_d, k, dim=1, largest=False, sorted=True)
                i = torch.gather(cand_i, 1, sel)
        dists[r0 : r0 + block] = d
        indices[r0 : r0 + block] = i
    return dists, indices


def knn_graph_host_chunked(
    X: torch.Tensor,
    Y: Optional[torch.Tensor] = None,
    k: int = 15,
    query_chunk: int = 131_072,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN called on host-level slices of ``query_chunk`` queries.

    The JAX package slices so that no single dispatch runs long enough for
    its TPU runtime to kill it. Each slice searches the whole database at
    k + 1 without the diagonal mask, and a stable reorder moves each row's
    own id to the end before the first k are kept, so the results equal
    :func:`knn_graph`'s.
    """
    n = X.shape[0]
    self_mode = Y is None
    Yc = X if self_mode else Y
    if n <= query_chunk:
        return knn_graph(X, Y, k=k, **kwargs)
    exclude = kwargs.pop("exclude_diag", self_mode)
    d_out, i_out = [], []
    for s in range(0, n, query_chunk):
        Xq = X[s : s + query_chunk]
        d, i = knn_graph(Xq, Yc, k=k + (1 if exclude else 0), exclude_diag=False, **kwargs)
        if exclude:
            rows = s + torch.arange(Xq.shape[0], device=X.device)
            is_self = (i == rows[:, None]).to(torch.int32)
            order = torch.argsort(is_self, dim=1, stable=True)
            d = torch.gather(d, 1, order)[:, :k]
            i = torch.gather(i, 1, order)[:, :k]
        d_out.append(d)
        i_out.append(i)
    return torch.cat(d_out), torch.cat(i_out)
