"""Distributed sparse symmetrization (counterpart of ``torchdr_tpu/parallel/sparse.py``).

The kNN edges of each shard's rows are bucketed by the shard that owns
their column, the buckets are exchanged (the JAX package's all_to_all),
and each shard merges the transposed edges it received with its own rows.

The JAX package pads every bucket to the worst case ``chunk·k`` because
XLA collectives need static shapes; the port moves each bucket at its own
length, as ``ops/sparse.symmetrize_sparse`` drops the padding edges up
front. Each shard packs its merged rows as ``symmetrize_sparse`` packs
them, so the result is the single-device one: where no row holds more
than ``k_out`` edges, also the JAX package's. Where ``k_out`` caps rows the
JAX package keeps the first ``k_out`` received edges of a row in arrival
order and then the lowest columns, so its mesh result differs from its own
single-device one; the port keeps the strongest edges on a mesh too
(ROADMAP, "Quirks of the reference").

Inside a fit the whole exchange, buckets through to the merged rows on the
input's device, is the span "exchange" of its ``timings_``
("affinity.exchange" in an estimator's affinity phase), synchronised on
every device of the mesh.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.sparse import pack_rows, resolve_k_out
from ..utils.profiling import span
from .mesh import pad_to_multiple


def _merge_rows(own, received, rows: int, n: int, k_out: int, value_order: bool, mode: str,
                dtypes):
    """Own edges and the received transposed edges of one shard's ``rows``
    rows (local row ids), merged by (row, column) and packed."""
    (o_r, o_c, o_v), (t_r, t_c, t_v) = own, received
    key = torch.cat([o_r * n + o_c, t_r * n + t_c])
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    n_own = o_r.shape[0]
    vP = torch.zeros(uniq.shape[0], dtype=o_v.dtype, device=o_v.device)
    vPT = torch.zeros_like(vP)
    vP.index_add_(0, inv[:n_own], o_v)
    vPT.index_add_(0, inv[n_own:], t_v)
    v = vP + vPT if mode == "sum" else vP + vPT - vP * vPT
    return pack_rows(torch.div(uniq, n, rounding_mode="floor"), uniq % n, v, rows, k_out,
                     value_order, dtypes)


def distributed_symmetrize_sparse(
    values: torch.Tensor,
    indices: torch.Tensor,
    mesh,
    mode: str = "sum_minus_prod",
    k_out: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetrize a row-sharded padded sparse matrix with an exchange of
    per-destination edge buckets.

    - ``mode="sum"``: Q = P + Pᵀ
    - ``mode="sum_minus_prod"``: Q = P + Pᵀ − P∘Pᵀ (UMAP fuzzy union)

    Inputs are global ``(n, k)`` tensors; shard r's rows go to
    ``mesh.devices[r]``. Returns ``(n, k_out)`` values and indices on the
    input's device, padded 0 / −1, with ``symmetrize_sparse``'s width and
    packing.
    """
    if mode not in ("sum", "sum_minus_prod"):
        raise ValueError(f"Unsupported mode {mode!r}")
    with span("exchange", mesh=mesh):
        return _exchange(values, indices, mesh, mode, k_out)


def _exchange(values, indices, mesh, mode, k_out):
    n, k = values.shape
    world = len(mesh)
    k_out, value_order = resolve_k_out(indices, k_out)
    chunk = pad_to_multiple(n, world) // world
    bounds = [(r * chunk, min(n, (r + 1) * chunk)) for r in range(world)]

    # each shard: its own edges, and one bucket of transposed edges per owner
    own, buckets = [], []
    for (r0, r1), dev in zip(bounds, mesh.devices):
        cols = indices[r0:r1].to(dev).reshape(-1).long()
        vals = values[r0:r1].to(dev).reshape(-1)
        rows = torch.arange(r0, max(r0, r1), device=dev).repeat_interleave(k)
        valid = cols >= 0
        rows, cols, vals = rows[valid], cols[valid], vals[valid]
        own.append((rows - r0, cols, vals))
        dest = torch.div(cols, chunk, rounding_mode="floor")
        # (row, column, value) of the transposed edge, for its row's owner
        buckets.append([(cols[dest == s], rows[dest == s], vals[dest == s])
                        for s in range(world)])

    out_vals, out_idx = [], []
    for s, ((r0, r1), dev) in enumerate(zip(bounds, mesh.devices)):
        # the exchange: bucket s of every shard, in rank order
        received = [tuple(t.to(dev) for t in buckets[src][s]) for src in range(world)]
        t_r, t_c, t_v = (torch.cat(parts) for parts in zip(*received))
        v, i = _merge_rows(own[s], (t_r - r0, t_c, t_v), max(0, r1 - r0), n, k_out, value_order,
                           mode, (values.dtype, indices.dtype))
        out_vals.append(v.to(values.device))
        out_idx.append(i.to(values.device))
    return torch.cat(out_vals), torch.cat(out_idx)
