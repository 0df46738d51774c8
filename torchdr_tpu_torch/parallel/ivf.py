"""Mesh-sharded IVF kNN search (counterpart of ``torchdr_tpu/parallel/ivf.py``).

The inverted-file index is built once, on the input's device, and
replicated on every device of the mesh; the self-query rows (the index's
sorted database rows) are cut into one slice per shard, each a whole
number of query blocks, and each shard's device runs the probe
(``ops/ivf._ivf_search_impl``) on its slice at its absolute layout
position. Shard boundaries fall on query-block boundaries, so every
block chooses the same cells as in the single-device search and the
results are those of ``ivf_knn`` over the same blocks. Under the split
tier the lo plane is cut with the query rows; the norms, scales, cell
table and supers are replicated with the rest of the index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.ivf import (
    IVFIndex,
    _check_search_args,
    _ivf_search_impl,
    _pad_queries,
    _resolve_search_knobs,
    ivf_build,
)
from ..utils.wrappers import full_float32
from .mesh import pad_to_multiple


def _index_on(index: IVFIndex, device: torch.device) -> IVFIndex:
    return index._replace(**{
        name: value.to(device) for name, value in index._asdict().items()
        if isinstance(value, torch.Tensor)
    })


@full_float32()
def ivf_knn_sharded(
    X,
    mesh,
    k: int = 15,
    nprobe: int = 12,
    n_clusters: Optional[int] = None,
    index: Optional[IVFIndex] = None,
    generator: Optional[torch.Generator] = None,
    block: int = 256,
    exclude_self: bool = True,
    m: Optional[int] = None,
    scan_precision: str = "high",
    budget: Optional[int] = None,
    scan_impl: str = "xla",
    merge: Optional[str] = None,
    scan_fidelity: str = "full",
    nprobe_supers: Optional[int] = None,
    nomination: Optional[str] = None,
    rerank: bool = True,
    storage: str = "auto",
    device="auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate self-kNN through an IVF index, queries sharded over a mesh.

    The contract of :func:`~torchdr_tpu_torch.ops.ivf.ivf_knn`: ``(dists,
    indices)`` of shape (n, k) in original row order, on the index's
    device; pass a prebuilt ``index`` (and X=None) to reuse a build.
    """
    _check_search_args("depth", scan_precision, scan_fidelity)
    if index is None:
        if X is None:
            raise ValueError("[TorchDR-Torch] ERROR : pass X or a prebuilt index.")
        index = ivf_build(X, n_clusters=n_clusters, generator=generator, storage=storage,
                          device=device)
    n, chunk = index.n, index.chunk
    nprobe, budget, m_eff, merge, max_ch, scan_impl, n_supers, nominate = _resolve_search_knobs(
        index, k, nprobe, m, budget, merge, scan_impl, nprobe_supers, nomination, rerank=rerank,
    )
    search = dict(k=k, ncells=nprobe, budget=budget, block=block, chunk=chunk, m=m_eff,
                  merge=merge, max_ch=max_ch, nominate=nominate, rerank=rerank,
                  scan_fidelity=scan_fidelity, n_supers=n_supers)

    # every row of the layout, padded with dead queries so that each shard
    # is a whole number of query blocks
    dev = index.X_sorted.device
    world = len(mesh)
    total = index.X_sorted.shape[0]
    n_pad = pad_to_multiple(total, world * block)
    Qs, Qs_lo, out_ids = index.X_sorted, index.X_lo, index.ids_sorted
    if n_pad != total:
        Qs, Qs_lo, out_ids = _pad_queries(Qs, Qs_lo, out_ids, n_pad - total)
    q_rows = torch.where(out_ids >= 0, out_ids + (0 if exclude_self else n), out_ids)
    shard = n_pad // world
    ds, is_, replicas = [], [], {}
    for r, shard_dev in enumerate(mesh.devices):
        if shard_dev not in replicas:
            replicas[shard_dev] = _index_on(index, shard_dev)
        idx = replicas[shard_dev]
        lo = r * shard
        lo_plane = None if Qs_lo is None else Qs_lo[lo : lo + shard].to(shard_dev)
        d, i = _ivf_search_impl(Qs[lo : lo + shard].to(shard_dev),
                                q_rows[lo : lo + shard].to(shard_dev), idx, pos0=lo,
                                Qs_lo=lo_plane, **search)
        ds.append(d.to(dev))
        is_.append(i.to(dev))
    # back to original row order (dead rows to the spill slot n)
    scatter_ids = torch.where(out_ids >= 0, out_ids, n).long()
    out_d = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
    out_i = torch.zeros((n + 1, k), dtype=torch.int32, device=dev)
    out_d[scatter_ids] = torch.cat(ds)
    out_i[scatter_ids] = torch.cat(is_)
    return out_d[:n], out_i[:n]
