"""kNN graphs from batch feeds (counterpart of ``torchdr_tpu/ops/streaming.py``).

- :func:`knn_graph_from_batches`: the exact tier; the database is
  assembled on the device from the batches.
- :func:`~torchdr_tpu_torch.ops.ivf.ivf_build_from_batches`: the IVF index
  written from the batches into its sorted layout.
- :func:`knn_graph_streaming`: beyond device memory. The database is cut
  into segments of whole batches; each segment gets its own IVF index and
  is queried by every row, and a running top-k is merged on the host. The
  device holds one segment's index and one query chunk; a replayed feed
  (a DataLoader, a factory) keeps host memory at the same scale.

Self matches are pushed to the end by a stable sort (exact tier) or
excluded by id (IVF).
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..base import resolve_device
from .distance import knn_graph
from .loader import BatchSource


def knn_graph_from_batches(
    batches: Iterable,
    k: int = 15,
    metric: str = "sqeuclidean",
    exclude_self: bool = True,
    precision: str = "highest",
    mode: str = "exact",
    block_size: int = 1024,
    mesh=None,
    device="auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of a dataset given as row batches, on ``device`` (with a
    ``mesh``: its first device).

    ``batches`` is anything :class:`~torchdr_tpu_torch.ops.loader.BatchSource`
    takes, read once. Returns (dists, indices) of shape (n, k) in the
    feed's row order; indices int32. With ``mesh`` each batch's query rows
    are cut over the mesh and searched against the replicated database
    (``parallel/knn.knn_graph_sharded_queries``).
    """
    dev = resolve_device(device, mesh)
    parts = [torch.from_numpy(b).to(dev) for b in BatchSource(batches)]
    if not parts:
        raise ValueError("[TorchDR-Torch] ERROR : empty batch iterable.")
    DB = torch.cat(parts, dim=0)

    k_search = k + 1 if exclude_self else k
    dists_out, idx_out = [], []
    offset = 0
    for Qb in parts:
        if mesh is not None:
            from ..parallel.knn import knn_graph_sharded_queries

            d, idx = knn_graph_sharded_queries(
                Qb, DB, k_search, mesh, metric=metric, block_size=block_size
            )
        else:
            d, idx = knn_graph(
                Qb, DB, k=k_search, metric=metric, exclude_diag=False,
                block_size=block_size, precision=precision, mode=mode,
            )
        if exclude_self:
            rows = offset + torch.arange(Qb.shape[0], device=dev)
            is_self = (idx == rows[:, None]).to(torch.int8)
            # self matches to the end, then the last column dropped
            order = torch.argsort(is_self, dim=1, stable=True)
            d = torch.gather(d, 1, order)[:, :k]
            idx = torch.gather(idx, 1, order)[:, :k]
        dists_out.append(d)
        idx_out.append(idx)
        offset += Qb.shape[0]
    return torch.cat(dists_out, dim=0), torch.cat(idx_out, dim=0)


def knn_graph_streaming(
    batches: Iterable,
    k: int = 15,
    nprobe: int = 12,
    n_clusters: Optional[int] = None,
    seg_bytes: Optional[int] = None,
    query_chunk: int = 1 << 20,
    exclude_self: bool = True,
    generator: Optional[torch.Generator] = None,
    verbose: bool = False,
    device="auto",
    timings: Optional[dict] = None,
    **ivf_kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate kNN graph of a dataset beyond device memory.

    The feed is cut into segments of whole batches of at most ``seg_bytes``
    float32 bytes (default: 45 % of the device's free memory less
    headroom). Each segment is indexed by
    :func:`~torchdr_tpu_torch.ops.ivf.ivf_build_from_batches` (with
    ``ivf_kwargs``) and queried by every row, ``query_chunk`` rows at a
    time; each answer is merged into the running top-k on the host. Each
    true neighbour lies in one segment and is found where its cell is
    probed there, so recall is the IVF tier's. A replayed feed is read
    again for each segment's build and queries.

    Returns host ``(dists, indices)`` of shape (n, k), ids int64. A
    ``timings`` dict receives the seconds spent in the segment builds
    ("build_s"), the device queries ("query_s") and the host merges
    ("merge_s").
    """
    from .ivf import _permute_hbm_budget, auto_nlist, ivf_build_from_batches, ivf_knn_queries

    dev = resolve_device(device)
    src = BatchSource(batches)
    meta = src.metadata()
    n, d = meta["n_samples"], meta["n_features"]
    sizes = meta["batch_sizes"]
    if seg_bytes is None:
        # the index planes take about the segment's bytes; the rest is for
        # the query chunks and the scan's buffers
        seg_bytes = max(1 << 28, int(_permute_hbm_budget(dev) * 0.45))

    # whole batches to a segment
    segments: list = []  # (batch_lo, batch_hi, n_rows)
    cur_lo = 0
    cur_bytes = cur_rows = 0
    for bi, m in enumerate(sizes):
        b_bytes = m * d * 4
        if bi > cur_lo and cur_bytes + b_bytes > seg_bytes:
            segments.append((cur_lo, bi, cur_rows))
            cur_lo, cur_bytes, cur_rows = bi, 0, 0
        cur_bytes += b_bytes
        cur_rows += m
    segments.append((cur_lo, len(sizes), cur_rows))

    spent = {"build_s": 0.0, "query_s": 0.0, "merge_s": 0.0}
    out_d = np.full((n, k), np.inf, np.float32)
    out_i = np.full((n, k), -1, np.int64)
    seg_start = 0
    for si, (blo, bhi, n_s) in enumerate(segments):
        nlist_s = n_clusters or auto_nlist(n_s)
        t0 = time.perf_counter()
        index = ivf_build_from_batches(
            src.slice(blo, bhi), n_clusters=nlist_s, generator=generator, device=dev,
            **ivf_kwargs,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        spent["build_s"] += time.perf_counter() - t0
        if verbose:
            print(f"[knn_graph_streaming] segment {si + 1}/{len(segments)}: "
                  f"{n_s} rows, nlist={nlist_s}", flush=True)
        q0 = 0
        for qb in src:
            for a in range(0, qb.shape[0], query_chunk):
                Qc = qb[a : a + query_chunk]
                gids = q0 + a + np.arange(Qc.shape[0])
                local = None
                if exclude_self:
                    local = gids - seg_start
                    local = np.where((local >= 0) & (local < n_s), local, n_s).astype(np.int32)
                t0 = time.perf_counter()
                d_q, i_q = ivf_knn_queries(
                    torch.from_numpy(Qc).to(dev), index, k=k, nprobe=nprobe, query_ids=local,
                )
                d_qh = d_q.cpu().numpy()
                i_qh = i_q.cpu().numpy().astype(np.int64) + seg_start
                t1 = time.perf_counter()
                # host top-k merge with the running best
                rows = slice(int(gids[0]), int(gids[-1]) + 1)
                cd = np.concatenate([out_d[rows], d_qh], axis=1)
                ci = np.concatenate([out_i[rows], i_qh], axis=1)
                sel = np.argpartition(cd, k - 1, axis=1)[:, :k]
                cd = np.take_along_axis(cd, sel, axis=1)
                ci = np.take_along_axis(ci, sel, axis=1)
                order = np.argsort(cd, axis=1)
                out_d[rows] = np.take_along_axis(cd, order, axis=1)
                out_i[rows] = np.take_along_axis(ci, order, axis=1)
                spent["query_s"] += t1 - t0
                spent["merge_s"] += time.perf_counter() - t1
            q0 += qb.shape[0]
        seg_start += n_s
        del index  # the segment's device buffers go before the next build
    if timings is not None:
        timings.update(spent)
    return out_d, out_i
