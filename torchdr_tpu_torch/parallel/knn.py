"""Multi-device kNN-graph construction (counterpart of ``torchdr_tpu/parallel/knn.py``).

- :func:`knn_graph_sharded` — queries row-sharded, database replicated:
  each shard's device runs the exact ``knn_graph`` on its row chunk against
  the whole database.
- :func:`knn_graph_sharded_queries` — the same for a separate database.
- :func:`knn_graph_ring` — queries and database row-sharded; at each of the
  world steps every shard's device holds one database shard, merges its
  distances into a running top-k, and passes the shard on to the next
  device (the JAX package's ``ppermute``). Exact, with O(n/p · d) database
  memory per device.

Shard r holds rows [r·chunk, (r+1)·chunk) with chunk = ⌈n / world⌉, as the
JAX package cuts its padded rows; the last shard is shorter instead of
padded. Results land on the input's device; indices are int32, as
``knn_graph`` returns them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.distance import _mask_self, knn_graph
from ..ops.metrics import MASK_VALUE, check_metric, pairwise_block
from .mesh import pad_to_multiple, replicate


def _row_chunks(n: int, world: int):
    chunk = pad_to_multiple(n, world) // world
    return [(r * chunk, min(n, (r + 1) * chunk)) for r in range(world)]


def knn_graph_sharded(
    X: torch.Tensor,
    k: int,
    mesh,
    metric: str = "sqeuclidean",
    exclude_diag: bool = True,
    block_size: int = 1024,
    mode: str = "exact",
    precision: str = "highest",
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN with row-sharded queries and a replicated database.

    ``mode``/``precision``/``recall_target`` are ``knn_graph``'s (the port's
    "approx" is its exact tier).
    """
    check_metric(metric)
    d_out, i_out = [], []
    for (r0, r1), X_full in zip(_row_chunks(X.shape[0], len(mesh)), replicate(X, mesh)):
        d, i = knn_graph(
            X_full[r0:r1], X_full, k=k, metric=metric, exclude_diag=exclude_diag,
            block_size=block_size, precision=precision, mode=mode,
            recall_target=recall_target, row_offset=r0,
        )
        d_out.append(d.to(X.device))
        i_out.append(i.to(X.device))
    return torch.cat(d_out), torch.cat(i_out)


def knn_graph_sharded_queries(
    Q: torch.Tensor,
    DB: torch.Tensor,
    k: int,
    mesh,
    metric: str = "sqeuclidean",
    block_size: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross kNN (queries against a separate database), queries row-sharded:
    each device searches its query chunk against the replicated database."""
    check_metric(metric)
    d_out, i_out = [], []
    for (r0, r1), DB_dev in zip(_row_chunks(Q.shape[0], len(mesh)), replicate(DB, mesh)):
        d, i = knn_graph(
            Q[r0:r1].to(DB_dev.device), DB_dev, k=k, metric=metric, exclude_diag=False,
            block_size=block_size,
        )
        d_out.append(d.to(Q.device))
        i_out.append(i.to(Q.device))
    return torch.cat(d_out), torch.cat(i_out)


def knn_graph_ring(
    X: torch.Tensor,
    k: int,
    mesh,
    metric: str = "sqeuclidean",
    exclude_diag: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the database passed around the ring of devices.

    Each step computes the (chunk × chunk) distance block between a shard's
    queries and the visiting database shard and merges it into the shard's
    running top-k.
    """
    check_metric(metric)
    world = len(mesh)
    bounds = _row_chunks(X.shape[0], world)
    queries = [X[r0:r1].to(dev) for (r0, r1), dev in zip(bounds, mesh.devices)]
    best_d = [torch.full((q.shape[0], k), MASK_VALUE, dtype=X.dtype, device=q.device)
              for q in queries]
    best_i = [torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device)
              for q in queries]
    db = list(queries)
    for s in range(world):
        for r, Xq in enumerate(queries):
            src = (r - s) % world  # origin rank of the visiting shard
            c0 = bounds[src][0]
            C = pairwise_block(Xq, db[r], metric)
            if exclude_diag:
                _mask_self(C, bounds[r][0], c0)
            cols = torch.arange(c0, c0 + C.shape[1], dtype=torch.int32, device=Xq.device)
            cand_d = torch.cat([best_d[r], C], dim=1)
            cand_i = torch.cat([best_i[r], cols.expand(C.shape[0], -1)], dim=1)
            best_d[r], sel = torch.topk(cand_d, k, dim=1, largest=False, sorted=True)
            best_i[r] = torch.gather(cand_i, 1, sel)
        # rotate: shard r's database goes to device r + 1
        db = [db[(r - 1) % world].to(dev) for r, dev in enumerate(mesh.devices)]
    return (torch.cat([d.to(X.device) for d in best_d]),
            torch.cat([i.to(X.device) for i in best_i]))
