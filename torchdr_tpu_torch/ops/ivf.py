"""IVF approximate kNN: coarse quantization + block-shared probe.

Counterpart of ``torchdr_tpu/ops/ivf.py``, float32 storage tier:

- **Build** (:func:`ivf_build`): k-means centroids on a sample
  (``ops/kmeans.py``), every row assigned by a blockwise argmin, the
  database sorted by cell so each inverted list is a contiguous row range,
  padded to a multiple of ``chunk`` rows (dead rows carry id −1). At
  nlist ≥ 1024 the centroids are k-meansed into equal-size supers and the
  cells relabelled so each super is a contiguous id range; at nlist ≥ 256
  each cell keeps its P nearest cells (``cell_adj``).
- **Search** (:func:`ivf_knn`, :func:`ivf_knn_queries`): queries go in
  blocks of ``block`` rows. Each block votes for the cells its queries want
  probed (flat: every centroid; adjacency: the nearest-cell lists of the
  block's home cells, sampled for self queries at rows ``j · chunk`` of
  the block for j < max(1, block // chunk), as in the JAX package),
  expands the vote-ordered cells into ``budget`` slots of ``chunk`` rows,
  scores the block against all of them in one product, keeps the best m
  per query (``merge``) and, with ``rerank``, recomputes those m distances
  exactly. A self-query block that straddles
  a cell boundary (block < chunk with ``chunk % block != 0``, or
  block ≥ chunk with ``block % chunk != 0``) never samples its second
  cell, and the rows there lose recall, in the JAX package too (ROADMAP,
  "Quirks of the reference"); a block that divides the chunk avoids it.

Where the JAX package maps a function over the blocks (``lax.map``), the
port runs ``G`` blocks at a time as one batched product, batched
``topk``, ``argsort`` and ``scatter_add_``; ``G`` is sized from the free
memory of the device. Each block keeps its own probe set, so the result is
that of one block at a time. Every shape inside the loop is fixed
(``budget``, ``ncells · max_ch``, ``n_home · P``), so the loop never waits
for the device.

Deviations from the JAX package (ROADMAP queue 3):

- ``lax.approx_min_k`` becomes an exact ``torch.topk``. On the CPU, XLA's
  lowering of ``approx_min_k`` is exact too; on a TPU it is binned.
- Every product is full float32 (TF32 off): ``scan_precision`` takes the
  JAX package's names and changes nothing, where the JAX package votes
  and scans at ``Precision.HIGH``. ``scan_fidelity`` ("full", "hi")
  changes nothing either: with float32 storage it changes nothing in the
  JAX package. Unknown values of both raise.
- ``scan_impl`` "xla", "slices" and "rows" run the same code. In the JAX
  package "slices" and "rows" exist only for TPU compiler limits on
  buffers over 4 GB (``ops/ivf.py:1148-1152, :1208-1211``).
- The bf16 residual split, int8 storage and supers nomination (ROADMAP
  item 12c) raise ``NotImplementedError``.
- On the card, votes and k-means sums are added by atomic operations whose
  order varies; cells whose vote totals are equal in exact arithmetic may
  rank either way between runs.
"""

from __future__ import annotations

import heapq
from typing import Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..base import resolve_device
from .distance import knn_graph
from .kmeans import kmeans_fit
from .metrics import MASK_VALUE

_TIER_12C = "is ROADMAP item 12c of the PyTorch port and not ported yet"
# rows of one host segment when a numpy dataset is assigned piecewise
_HOST_SEG_ROWS = 1 << 20
# headroom kept free on the card beside the build's permute and the search
_HEADROOM = 3 << 30


class IVFIndex(NamedTuple):
    centroids: torch.Tensor  # (ncells, d) float32
    X_sorted: torch.Tensor  # (n_pad + chunk, d) database rows grouped by cell
    ids_sorted: torch.Tensor  # (n_pad + chunk,) int32 original row ids (-1 padding)
    offsets: torch.Tensor  # (ncells,) int32 start of each cell in X_sorted
    counts: torch.Tensor  # (ncells,) int32 cell sizes
    chunk: int  # probe granularity (rows of one scan slot)
    n: int  # number of real database rows
    X_lo: Optional[torch.Tensor] = None  # residual split tier (item 12c)
    xnorm2: Optional[torch.Tensor] = None  # residual / int8 tiers (item 12c)
    cells_sorted: Optional[torch.Tensor] = None  # (n_pad + chunk,) int32 cell of each row slot
    super_centroids: Optional[torch.Tensor] = None  # (S, d) means of the supers
    super_members: Optional[torch.Tensor] = None  # (S, W) int32 member cells, -1 padding
    cell_adj: Optional[torch.Tensor] = None  # (ncells, P) int32 nearest cells, self first
    scales: Optional[torch.Tensor] = None  # int8 tier (item 12c)


def auto_nlist(n: int) -> int:
    """Faiss-style heuristic for the number of cells."""
    return int(max(16, min(4 * (n**0.5), n / 39, 8192)))


def _balance_allocate(counts_h: np.ndarray, extras: int) -> np.ndarray:
    """Greedy water-filling of ``extras`` split centroids over cells.

    Each extra goes to the cell with the largest residual share
    count/(e+1); a cell never gets more extras than members − 1.
    """
    e = np.zeros(counts_h.shape[0], np.int64)
    heap = [(-float(c), int(i)) for i, c in enumerate(counts_h) if c > 1]
    heapq.heapify(heap)
    for _ in range(int(extras)):
        if not heap:
            break
        _, i = heapq.heappop(heap)
        e[i] += 1
        if e[i] + 1 < counts_h[i]:
            heapq.heappush(heap, (-counts_h[i] / (e[i] + 1.0), i))
    return e


def _permute_hbm_budget(device: torch.device) -> int:
    """Bytes the build may hold on ``device`` beside what is allocated: the
    card's free memory less headroom (no limit for the CPU)."""
    if device.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(device)
    return int(free) - _HEADROOM


def _lloyd_means(X, labels_h: np.ndarray, centroids: torch.Tensor) -> torch.Tensor:
    """One full-data Lloyd mean update; empty cells keep their centroid.
    ``X`` is a tensor or, on the host path, a numpy array."""
    nlist, d = centroids.shape
    counts = torch.from_numpy(np.bincount(labels_h, minlength=nlist).astype(np.float32))
    if isinstance(X, np.ndarray):
        sums = torch.zeros((nlist, d), dtype=torch.float32)
        sums.index_add_(
            0, torch.from_numpy(labels_h.astype(np.int64)),
            torch.from_numpy(np.ascontiguousarray(X, np.float32)),
        )
    else:
        sums = torch.zeros((nlist, d), dtype=torch.float32, device=X.device)
        sums.index_add_(0, torch.from_numpy(labels_h.astype(np.int64)).to(X.device), X)
    sums = sums.to(centroids.device)
    cnt = counts.to(centroids.device)[:, None]
    return torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), centroids)


def _cells_of_layout(padded_h: np.ndarray, chunk: int, nlist: int) -> np.ndarray:
    """Host: cell id of every row slot in the aligned sorted layout."""
    cells_h = np.repeat(np.arange(nlist, dtype=np.int32), padded_h)
    return np.concatenate([cells_h, np.full((chunk,), max(0, nlist - 1), np.int32)])


def _assign_blockwise(X: torch.Tensor, centroids: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Nearest centroid of every row of X (int32), on X's device. Rows go
    ``block · G`` at a time, G sized so a distance block stays ≤ 2^25
    elements."""
    c_norm = torch.sum(centroids * centroids, dim=-1)
    rows = max(block, (1 << 25) // max(1, centroids.shape[0]) // block * block)
    out = torch.empty((X.shape[0],), dtype=torch.int32, device=X.device)
    for r0 in range(0, X.shape[0], rows):
        Xb = X[r0 : r0 + rows].to(torch.float32)
        D = torch.clamp(
            torch.sum(Xb * Xb, -1)[:, None] + c_norm[None, :] - 2.0 * (Xb @ centroids.T), min=0.0
        )
        out[r0 : r0 + rows] = torch.argmin(D, dim=1).to(torch.int32)
    return out


def _assign_host_segmented(Xh: np.ndarray, centroids: torch.Tensor) -> np.ndarray:
    """Blockwise argmin for a host-resident (numpy) dataset too large for
    the card: pushes ``_HOST_SEG_ROWS``-row segments and pulls only the
    int32 labels back."""
    n = Xh.shape[0]
    out = np.empty((n,), np.int32)
    for a in range(0, n, _HOST_SEG_ROWS):
        seg = torch.from_numpy(np.ascontiguousarray(Xh[a : a + _HOST_SEG_ROWS], np.float32))
        lab = _assign_blockwise(seg.to(centroids.device), centroids)
        out[a : a + seg.shape[0]] = lab.cpu().numpy()
    return out


def _build_supers(centroids: torch.Tensor, S: int, generator, super_init=None):
    """Two-level quantizer with equal-size supers via cell relabelling.

    Returns ``(perm, super_centroids, super_members)``: ``perm`` (numpy)
    orders the cells by (k-means super, distance to it) under a capacity
    of 1.25× the mean membership; the caller applies
    ``centroids = centroids[perm]`` so each super's members are a
    contiguous id range. ``super_init`` takes a given k-means seeding.
    """
    sup_c, _, _ = kmeans_fit(
        centroids, S, generator, max_iter=25, init="random" if S >= 2048 else "++",
        init_centers=super_init,
    )
    cent_h = centroids.cpu().numpy().astype(np.float32)
    sup_h = sup_c.cpu().numpy().astype(np.float32)
    nlist = cent_h.shape[0]
    cap = -(-int(np.ceil(nlist / S * 1.25)) // 4) * 4
    Dm = (
        (cent_h * cent_h).sum(1)[:, None]
        + (sup_h * sup_h).sum(1)[None, :]
        - 2.0 * cent_h @ sup_h.T
    )
    pref = np.argsort(Dm, axis=1)
    gap = Dm[np.arange(nlist), pref[:, 1]] - Dm[np.arange(nlist), pref[:, 0]]
    counts = np.zeros((S,), np.int64)
    assigned = np.empty((nlist,), np.int64)
    for c in np.argsort(-gap):
        for s in pref[c]:
            if counts[s] < cap:
                assigned[c] = s
                counts[s] += 1
                break
    d_own = Dm[np.arange(nlist), assigned]
    perm = np.lexsort((d_own, assigned))
    members = np.full((S, cap), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    new_ids = np.arange(nlist, dtype=np.int32)
    for s in range(S):
        members[s, : counts[s]] = new_ids[starts[s] : starts[s] + counts[s]]
    cent_sorted = cent_h[perm]
    sums = np.add.reduceat(cent_sorted, np.minimum(starts, nlist - 1), axis=0)
    sums *= (counts > 0)[:, None]
    sup_means = (sums / np.maximum(counts, 1)[:, None]).astype(np.float32)
    dev = centroids.device
    return perm, torch.from_numpy(sup_means).to(dev), torch.from_numpy(members).to(dev)


def _build_cell_adjacency(centroids: torch.Tensor, P: Optional[int] = None):
    """(ncells, P) int32 nearest-cell table (self first) for adjacency
    nomination; None below 256 cells, where flat nomination is cheap."""
    nlist = centroids.shape[0]
    if nlist < 256:
        return None
    P = P or min(64, int(nlist))
    _, adj = knn_graph(centroids, k=P, exclude_diag=False, block_size=1024)
    return adj


def ivf_build(
    X,
    n_clusters: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    train_size: int = 25_600,
    kmeans_iters: int = 25,
    chunk: Optional[int] = None,
    align: bool = True,
    verbose: bool = False,
    split_bytes: int = 4 << 30,
    n_superlist: Optional[int] = None,
    storage: str = "auto",
    balance_extra: Optional[int] = None,
    device="auto",
    train_idx=None,
    init_centers=None,
    super_init=None,
) -> IVFIndex:
    """Build the inverted file index.

    ``X`` is a tensor (the index is built and permuted on its device; a
    device out of memory raises) or a numpy array (built on ``device``:
    "auto" is the card). A numpy dataset that fits the card twice over is
    pushed once and built there; a larger one is assigned in pushed
    segments and permuted on the host, and only the sorted database is
    pushed.

    ``balance_extra`` splits the heaviest cells by seeding up to that many
    extra centroids from their own members, then one full-data Lloyd step
    and a reassignment (default 0, off, as in the JAX package).
    ``storage``: "auto" and "f32" build float32 storage; "auto" past
    ``split_bytes``, "split" and "int8" raise ``NotImplementedError``.

    The random draws come from ``generator`` (default: seeded with 0).
    ``train_idx`` (the k-means sample's rows), ``init_centers`` (its
    seeding) and ``super_init`` (the supers' seeding) take given draws.
    """
    if storage not in ("auto", "f32", "split", "int8"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown storage {storage!r}")
    if storage in ("split", "int8"):
        raise NotImplementedError(f"[TorchDR-Torch] ERROR : storage={storage!r} {_TIER_12C}.")
    is_host = isinstance(X, np.ndarray)
    dev = resolve_device(device) if is_host else X.device
    n, d = X.shape
    nlist = n_clusters or auto_nlist(n)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    if chunk is None:
        mean_cell = max(1, n // max(1, nlist))
        chunk = int(min(512, max(64, -(-int(1.3 * mean_cell) // 64) * 64)))
    chunk = min(chunk, max(64, n))

    # a numpy dataset that fits the device twice over (itself and the
    # sorted copy) is pushed once and built there
    if is_host and 2 * n * d * 4 + (1 << 30) < _permute_hbm_budget(dev):
        X = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
        is_host = False
    if not is_host:
        X = X.to(torch.float32)

    train_size = min(n, max(train_size, 64 * nlist))
    if n <= train_size and train_idx is None:
        sel = None
    elif train_idx is not None:
        sel = torch.as_tensor(np.array(train_idx), dtype=torch.int64)
    else:
        sel = torch.randperm(n, generator=generator, device=dev)[:train_size].cpu()
    if is_host:
        rows_h = slice(None) if sel is None else sel.numpy()
        train = torch.from_numpy(np.ascontiguousarray(X[rows_h], np.float32)).to(dev)
    else:
        train = X if sel is None else X[sel.to(dev)]
    centroids, _, _ = kmeans_fit(
        train, nlist, generator, max_iter=kmeans_iters,
        init="random" if nlist >= 2048 else "++", init_centers=init_centers,
    )
    del train

    def _assign(cent):
        if is_host:
            lab = _assign_host_segmented(X, cent)
        else:
            lab = _assign_blockwise(X, cent).cpu().numpy()
        return lab, np.bincount(lab, minlength=cent.shape[0]).astype(np.int64)

    labels_h, counts_h64 = _assign(centroids)

    balance_extra = int(min(balance_extra or 0, max(0, n - nlist)))
    if balance_extra > 0:
        e = _balance_allocate(counts_h64, balance_extra)
        order0 = np.argsort(labels_h, kind="stable")
        raw = np.concatenate([[0], np.cumsum(counts_h64)[:-1]])
        seed_idx, seed_cell = [], []
        for i in np.nonzero(e)[0]:
            mem = order0[raw[i] : raw[i] + counts_h64[i]]
            pos = np.unique(np.linspace(0, len(mem) - 1, e[i] + 2)[1:-1].astype(np.int64))
            seed_idx.append(mem[pos])
            seed_cell.append(np.full(len(pos), i, np.int64))
        if seed_idx:
            seed_idx = np.concatenate(seed_idx)
            seed_cell = np.concatenate(seed_cell)
            if is_host:
                members = torch.from_numpy(np.ascontiguousarray(X[seed_idx], np.float32)).to(dev)
            else:
                members = X[torch.from_numpy(seed_idx).to(dev)]
            # seeds at centroid + 0.25 (member - centroid): cones through
            # the centroid split a tight cell at any dimension
            home = centroids[torch.from_numpy(seed_cell).to(dev)]
            centroids = torch.cat([centroids, home + 0.25 * (members - home)], dim=0)
            nlist = int(centroids.shape[0])
            labels_h, counts_h64 = _assign(centroids)
            centroids = _lloyd_means(X, labels_h, centroids)
            labels_h, counts_h64 = _assign(centroids)

    if n_superlist is None:
        n_superlist = max(32, nlist // 64) if nlist >= 1024 else 0
    if n_superlist and n_superlist < nlist:
        perm_s, supers, members = _build_supers(centroids, int(n_superlist), generator, super_init)
        centroids = centroids[torch.from_numpy(perm_s).to(dev)]
        inv_perm = np.empty((nlist,), np.int64)
        inv_perm[perm_s] = np.arange(nlist)
        labels_h = inv_perm[labels_h].astype(np.int32)
        counts_h64 = counts_h64[perm_s]
    else:
        supers = members = None
    cell_adj = _build_cell_adjacency(centroids)
    counts = torch.from_numpy(counts_h64.astype(np.int32)).to(dev)

    if not align:
        order_h = np.argsort(labels_h, kind="stable")
        offs_h = np.concatenate([[0], np.cumsum(counts_h64)[:-1]]).astype(np.int32)
        order = torch.from_numpy(order_h).to(dev)
        if is_host:
            X_sorted = torch.from_numpy(np.ascontiguousarray(X[order_h], np.float32)).to(dev)
        else:
            X_sorted = X[order]
        X_sorted = torch.cat([X_sorted, torch.zeros((chunk, d), dtype=torch.float32, device=dev)])
        ids_sorted = torch.cat(
            [order.to(torch.int32), torch.full((chunk,), -1, dtype=torch.int32, device=dev)]
        )
        return IVFIndex(
            centroids, X_sorted, ids_sorted, torch.from_numpy(offs_h).to(dev), counts, chunk, n,
            super_centroids=supers, super_members=members,
        )

    padded = np.ceil(counts_h64 / chunk).astype(np.int64) * chunk
    offs_h = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    total = int(padded.sum())
    raw_offs = np.concatenate([[0], np.cumsum(counts_h64)[:-1]])
    order_h = np.argsort(labels_h, kind="stable")
    lab_sorted = labels_h[order_h]
    dest_h = offs_h[lab_sorted] + (np.arange(n) - raw_offs[lab_sorted])
    if storage == "auto" and (total + chunk) * d * 4 > split_bytes:
        raise NotImplementedError(
            f"[TorchDR-Torch] ERROR : the database is larger than split_bytes "
            f"({split_bytes}); the bf16 residual split {_TIER_12C}. Pass storage='f32'."
        )
    cells_sorted = torch.from_numpy(_cells_of_layout(padded, chunk, nlist)).to(dev)
    dest_src = np.empty((n,), np.int64)
    dest_src[order_h] = dest_h  # row j of X lands at dest_src[j]
    ids_h = np.full((total + chunk,), -1, np.int32)
    ids_h[dest_h] = order_h
    if not is_host:
        X_sorted = torch.zeros((total + chunk, d), dtype=torch.float32, device=dev)
        X_sorted.index_copy_(0, torch.from_numpy(dest_src).to(dev), X)
    else:
        # host permutation: the sorted database crosses to the card once
        out = torch.zeros((total + chunk, d), dtype=torch.float32)
        out.index_copy_(
            0, torch.from_numpy(dest_src), torch.from_numpy(np.ascontiguousarray(X, np.float32))
        )
        X_sorted = out.to(dev)
    return IVFIndex(
        centroids, X_sorted, torch.from_numpy(ids_h).to(dev),
        torch.from_numpy(offs_h.astype(np.int32)).to(dev), counts, chunk, n,
        cells_sorted=cells_sorted, super_centroids=supers, super_members=members,
        cell_adj=cell_adj,
    )


def index_from_numpy(fields: Union[Mapping, NamedTuple], device="auto") -> IVFIndex:
    """An :class:`IVFIndex` on ``device`` ("auto": the card, raising without
    one) from the fields of an index given as arrays (a mapping, or a
    ``NamedTuple`` such as the JAX package's ``IVFIndex``): float fields
    become float32 tensors, integer fields int32, ``chunk`` and ``n`` ints.
    Anything ``np.asarray`` reads is taken; storage tiers other than float32
    raise."""
    device = resolve_device(device)
    fields = dict(fields._asdict() if hasattr(fields, "_asdict") else fields)
    for name in ("X_lo", "xnorm2", "scales"):
        if fields.get(name) is not None:
            raise NotImplementedError(f"[TorchDR-Torch] ERROR : index field {name} {_TIER_12C}.")
    out = {}
    for name in IVFIndex._fields:
        v = fields.get(name)
        if name in ("chunk", "n"):
            out[name] = int(v)
        elif v is not None:
            a = np.array(v)
            dtype = torch.float32 if np.issubdtype(a.dtype, np.floating) else torch.int32
            out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
    return IVFIndex(**out)


def _resolve_search_knobs(index, k, nprobe, m, budget, merge, scan_impl,
                          nprobe_supers=None, nomination=None,
                          has_q_cells=False, rerank=True):
    """Resolve the data-dependent search knobs for an index: (nprobe,
    budget, m_eff, merge, max_ch, scan_impl, n_supers, nominate), with
    the JAX package's arithmetic."""
    if scan_impl not in ("xla", "slices", "rows"):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : unknown scan_impl {scan_impl!r} "
            "(choose 'xla', 'slices' or 'rows')."
        )
    if nomination not in (None, "flat", "adjacency", "supers"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown ivf nomination {nomination!r}")
    if merge not in (None, "approx", "exact", "tournament"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown ivf merge {merge!r}")
    if nomination == "supers" or nprobe_supers:
        raise NotImplementedError(f"[TorchDR-Torch] ERROR : supers nomination {_TIER_12C}.")
    chunk = index.chunk
    nlist_total = int(index.centroids.shape[0])
    if nomination is None:
        adj_ok = index.cell_adj is not None and (index.cells_sorted is not None or has_q_cells)
        nomination = "adjacency" if adj_ok and nlist_total >= 1024 else "flat"
    if merge is None:
        merge = "approx"  # float32 storage; the residual tiers take "tournament"
    nprobe = min(nprobe, int(index.offsets.shape[0]))
    counts_h = index.counts.cpu().numpy().astype(np.float64)
    # expansion depth must cover the biggest cell
    max_ch = int(np.ceil(float(np.max(counts_h)) / chunk)) if counts_h.size else 1
    if budget is None:
        # size-biased mean of per-cell chunk counts over the probed cells,
        # plus slack, and at least the biggest home cell's depth
        total = counts_h.sum()
        sb_chunks = (
            float((counts_h * np.ceil(counts_h / chunk)).sum() / total) if total > 0 else 1.0
        )
        budget = int(np.ceil(nprobe * max(1.0, sb_chunks)) + 4)
        budget = max(budget, max_ch + 1)
    budget = min(budget, (index.X_sorted.shape[0] - chunk) // chunk + 1)
    if not rerank:
        m_eff = k if m is None else max(int(m), k)
    elif m is not None:
        m_eff = m
    elif merge == "tournament":
        m_eff = max(k + 5, 20)
    else:
        m_eff = max(2 * k, 32)
    return nprobe, budget, m_eff, merge, max_ch, scan_impl, 0, nomination


def _group_size(device: torch.device, per_block_bytes: int, n_blocks: int) -> int:
    """Blocks run at once: an eighth of the card's free memory (64 MB on
    the CPU) over one block's transient bytes, at most 256."""
    if device.type == "cuda":
        room = max(0, _permute_hbm_budget(device)) // 8
    else:
        room = 64 << 20
    return int(max(1, min(n_blocks, 256, room // max(1, per_block_bytes))))


def _top_cells(score: torch.Tensor, ncells: int):
    """The ``ncells`` largest scores of each row, equal scores in index
    order as ``lax.top_k`` takes them: a vote total outweighs the distance
    term, so cells with equal votes tie exactly."""
    v, i = torch.sort(score, dim=1, descending=True, stable=True)
    return v[:, :ncells], i[:, :ncells]


def _ivf_search_impl(
    Qs, q_rows, index: IVFIndex, k, ncells, budget, block, chunk, m, max_ch,
    merge="approx", pos0=0, queries_raw=False, nominate="flat",
    q_cells=None, rerank=True, budget_order="depth",
):
    """The probe over ``Qs`` (nq, d), nq a multiple of ``block``: returns
    (dists, ids) of shape (nq, k), ids int32. ``q_rows`` is the id each
    query must not return (negative: a dead query, which does not vote).
    Self queries sit at absolute layout position ``pos0 + i``; raw queries
    carry their home cells in ``q_cells``."""
    centroids, X_sorted, ids_sorted = index.centroids, index.X_sorted, index.ids_sorted
    offsets, counts, cells_sorted, cell_adj = (
        index.offsets.long(), index.counts, index.cells_sorted, index.cell_adj
    )
    dev = Qs.device
    use_adj = (
        nominate == "adjacency"
        and cell_adj is not None
        and (q_cells is not None or cells_sorted is not None)
        and cell_adj.shape[1] >= ncells
    )
    nq, d = Qs.shape
    n_blocks = nq // block
    nlist = centroids.shape[0]
    n_total = X_sorted.shape[0] - chunk  # valid rows (the tail is padding)
    c_norm = torch.sum(centroids * centroids, dim=-1)
    per_query_probes = max(2, min(nlist, ncells))
    aligned = n_total % chunk == 0
    if aligned:
        X_r = X_sorted[:n_total].reshape(n_total // chunk, chunk, d)
        ids_r = ids_sorted[:n_total].reshape(n_total // chunk, chunk)
    weights = 1.0 / (1.0 + torch.arange(per_query_probes, dtype=torch.float32, device=dev))
    ar_chunk = torch.arange(chunk, device=dev)
    # slot grid: (cell rank, chunk depth) of each of the ncells · max_ch slots
    ci_g = torch.arange(ncells, device=dev).repeat(max_ch)
    w_g = torch.arange(max_ch, device=dev).repeat_interleave(ncells)
    if budget_order == "rank":
        prio_g = torch.where(
            ci_g == 0, w_g,
            torch.where(w_g == 0, max_ch + ci_g, max_ch + ncells + ci_g * max_ch + w_g),
        )
    else:
        prio_g = torch.where(ci_g == 0, w_g, max_ch + w_g * ncells + ci_g)
    int_max = torch.iinfo(torch.int64).max
    n_slots = min(budget, ncells * max_ch)
    if use_adj:
        P_adj = cell_adj.shape[1]
        n_home = min(8, block) if queries_raw else max(1, block // chunk)
        n_cand = n_home * P_adj
    else:
        n_cand = nlist
    W = n_slots * chunk
    per_block = 4 * block * (3 * W + 3 * n_cand + m * (d + 4)) + 4 * W * (d + 4)
    G = _group_size(dev, per_block, n_blocks)

    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    for b0 in range(0, n_blocks, G):
        g = min(G, n_blocks - b0)
        r0, r1 = b0 * block, (b0 + g) * block
        Qb = Qs[r0:r1].to(torch.float32).reshape(g, block, d)
        rows = q_rows[r0:r1].reshape(g, block)
        qn = torch.sum(Qb * Qb, dim=-1)  # (g, block)
        alive = (rows >= 0).to(torch.float32)
        w_q = alive[:, :, None] * weights  # (g, block, P)
        blk = torch.arange(b0, b0 + g, device=dev)
        if use_adj:
            if queries_raw:
                samp = blk[:, None] * block + torch.arange(n_home, device=dev) * (block // n_home)
                home = q_cells[samp]
            else:
                samp = pos0 + blk[:, None] * block + torch.arange(n_home, device=dev) * chunk
                home = cells_sorted[torch.clamp(samp, max=cells_sorted.shape[0] - 1)]
            cand = torch.sort(cell_adj[home.long()].reshape(g, -1), dim=1).values
            dup = torch.cat(
                [torch.zeros((g, 1), dtype=torch.bool, device=dev), cand[:, 1:] == cand[:, :-1]], 1
            )
            members = torch.where(dup, -1, cand).long()
            mvalid = members >= 0
            mem = torch.clamp(members, min=0)
            gq_m = torch.bmm(Qb, centroids[mem].transpose(1, 2))  # (g, block, M)
            Dc = torch.clamp(qn[:, :, None] + c_norm[mem][:, None, :] - 2.0 * gq_m, min=0.0)
            Dc = Dc + MASK_VALUE * (~mvalid)[:, None, :].to(Dc.dtype)
            nom = torch.topk(Dc, per_query_probes, dim=2, largest=False).indices
            votes = torch.zeros((g, mem.shape[1]), dtype=torch.float32, device=dev)
            votes.scatter_add_(1, nom.reshape(g, -1), w_q.reshape(g, -1))
            votes = torch.where(mvalid, votes, -1.0)
            score = votes - torch.min(Dc, dim=1).values / 1e12
            sv, msel = _top_cells(score, ncells)
            cells = torch.gather(mem, 1, msel)
            cells_valid = sv > -0.5
        else:
            gq = torch.matmul(Qb, centroids.T)  # (g, block, nlist)
            Dc = torch.clamp(qn[:, :, None] + c_norm - 2.0 * gq, min=0.0)
            nom = torch.topk(Dc, per_query_probes, dim=2, largest=False).indices
            votes = torch.zeros((g, nlist), dtype=torch.float32, device=dev)
            votes.scatter_add_(1, nom.reshape(g, -1), w_q.reshape(g, -1))
            score = votes - torch.min(Dc, dim=1).values / 1e12
            cells = _top_cells(score, ncells)[1]
            cells_valid = torch.ones_like(cells, dtype=torch.bool)

        # expand the vote-ordered cells into `budget` chunk slots: the home
        # cell's chunks first, then by (depth, rank) or (rank, depth)
        cnts = torch.where(cells_valid, counts[cells].long(), 0)  # (g, ncells)
        nch = (cnts + (chunk - 1)) // chunk
        live = w_g < nch[:, ci_g]  # (g, ncells · max_ch)
        prio = torch.where(live, prio_g, int_max)
        order = torch.argsort(prio, dim=1, stable=True)[:, :budget]
        sel_ci = ci_g[order]
        sel_w = w_g[order]
        sel_live = torch.gather(live, 1, order)
        slot_start = torch.where(
            sel_live, offsets[torch.gather(cells, 1, sel_ci)] + sel_w * chunk, n_total
        )  # (g, n_slots); dead slots point at the padded tail
        slot_valid = torch.where(sel_live, torch.gather(cnts, 1, sel_ci) - sel_w * chunk, 0)
        row_idx = (slot_start[:, :, None] + ar_chunk).reshape(g, -1)  # (g, W)
        if aligned:
            # whole chunks; a dead slot reads the last chunk, all masked
            cid = torch.clamp(slot_start // chunk, max=n_total // chunk - 1)
            Xg_all = X_r[cid].reshape(g, -1, d)
            idg = ids_r[cid].reshape(g, -1)
        else:
            Xg_all = X_sorted[row_idx]
            idg = ids_sorted[row_idx]
        col_dead = (ar_chunk >= slot_valid[:, :, None]).reshape(g, -1)
        idg = torch.where(col_dead, -1, idg)

        ng = torch.sum(Xg_all * Xg_all, dim=-1)  # (g, W)
        sc = ng[:, None, :] - 2.0 * torch.bmm(Qb, Xg_all.transpose(1, 2))  # (g, block, W)
        invalid = (idg[:, None, :] < 0) | (idg[:, None, :] == rows[:, :, None])
        buf = sc + MASK_VALUE * invalid.to(sc.dtype)
        del sc, invalid
        if merge == "tournament":
            # per-slot top t, then top m of the survivors: exact for k <= t
            t = min(chunk, max(16, k))
            nsl = buf.shape[2] // chunk
            v1, i1 = torch.topk(buf.reshape(g, block, nsl, chunk), t, dim=3, largest=False)
            vals, i2 = torch.topk(
                v1.reshape(g, block, nsl * t), min(m, nsl * t), dim=2, largest=False
            )
            within = torch.gather(i1.reshape(g, block, nsl * t), 2, i2)
            cidx = (i2 // t) * chunk + within
        else:  # "exact", and "approx": an exact topk in the port
            vals, cidx = torch.topk(buf, m, dim=2, largest=False)
        del buf
        pos = torch.gather(row_idx[:, None, :].expand(g, block, W), 2, cidx)  # (g, block, m)
        if not rerank:
            # scan scores are float32 distances less |q|²: assemble D²
            D2 = torch.where(
                vals[..., :k] >= MASK_VALUE * 0.5, MASK_VALUE, vals[..., :k] + qn[..., None]
            )
            ids = ids_sorted[pos[..., :k]]
        else:
            diff = Qb[:, :, None, :] - X_sorted[pos]  # (g, block, m, d)
            D2 = torch.sum(diff * diff, dim=-1)
            D2 = torch.where(vals >= MASK_VALUE * 0.5, MASK_VALUE, D2)
            D2, sel = torch.topk(D2, k, dim=2, largest=False)
            ids = ids_sorted[torch.gather(pos, 2, sel)]
        out_d[r0:r1] = D2.reshape(-1, k)
        out_i[r0:r1] = ids.reshape(-1, k)
    return out_d, out_i


def _check_search_args(budget_order, scan_precision, scan_fidelity, scoring=None):
    """Reject option values the port cannot honour. ``scan_precision`` takes
    the JAX package's three names: every product here is full float32, as
    exact as the most exact of them. ``scan_fidelity`` "hi" drops the
    residual plane's cross terms, which float32 storage does not have: with
    it "full" and "hi" are the same search, in the JAX package too."""
    if scan_precision not in ("default", "high", "highest"):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : unknown scan_precision {scan_precision!r} "
            "(choose 'default', 'high' or 'highest')."
        )
    if scan_fidelity not in ("full", "hi"):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : unknown scan_fidelity {scan_fidelity!r} "
            "(choose 'full' or 'hi')."
        )
    if budget_order not in ("depth", "rank"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown budget_order {budget_order!r}")
    if scoring is not None and scoring not in ("symmetric", "asymmetric"):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : unknown scoring {scoring!r} "
            "(choose 'symmetric' or 'asymmetric')."
        )


def ivf_knn(
    X,
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
    seg_rows: int = 1 << 21,
    scan_fidelity: str = "full",
    nprobe_supers: Optional[int] = None,
    nomination: Optional[str] = None,
    rerank: bool = True,
    budget_order: str = "depth",
    storage: str = "auto",
    scoring: str = "symmetric",
    device="auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate self-kNN of X through an IVF index.

    Returns (dists, indices) of shape (n, k) in original row order: squared
    distances, int32 ids. Pass a prebuilt ``index`` (and X=None) to reuse
    a build; otherwise the index is built from X (``ivf_build`` with
    ``n_clusters``, ``generator``, ``storage``, ``device``).

    The queries are the index's sorted rows themselves (no assignment or
    gather), in segments of ``seg_rows``; dead layout rows ride along as
    dead queries and land on a spill slot. ``rerank=False`` returns the
    scan scores assembled into distances (selection at width k).
    ``scoring="asymmetric"`` scores X's own rows in layout order (the
    same numbers for float32 storage). ``scan_precision``,
    ``scan_fidelity`` and ``scan_impl`` take the JAX package's values and
    each gives the same result for every one of them (module docstring,
    ``_check_search_args``); other values raise.
    """
    _check_search_args(budget_order, scan_precision, scan_fidelity, scoring)
    if index is None:
        if X is None:
            raise ValueError("[TorchDR-Torch] ERROR : pass X or a prebuilt index.")
        index = ivf_build(X, n_clusters=n_clusters, generator=generator, storage=storage,
                          device=device)
    asym = scoring == "asymmetric"
    dev = index.X_sorted.device
    if asym:
        if X is None:
            raise ValueError(
                "[TorchDR-Torch] ERROR : scoring='asymmetric' needs X (the "
                "exact float32 rows) alongside the index."
            )
        X_exact = torch.as_tensor(X, dtype=torch.float32).to(dev)
    n = index.n
    nprobe, budget, m_eff, merge, max_ch, scan_impl, _, nominate = _resolve_search_knobs(
        index, k, nprobe, m, budget, merge, scan_impl, nprobe_supers, nomination, rerank=rerank,
    )
    chunk = index.chunk
    search = dict(k=k, ncells=nprobe, budget=budget, block=block, chunk=chunk, m=m_eff,
                  merge=merge, max_ch=max_ch, nominate=nominate, rerank=rerank,
                  budget_order=budget_order)

    total = index.X_sorted.shape[0] - chunk
    if (total + chunk) % block == 0:
        total = total + chunk
        Qs, out_ids = index.X_sorted, index.ids_sorted
    else:
        n_pad = -(-total // block) * block
        Qs, out_ids = index.X_sorted[:total], index.ids_sorted[:total]
        if n_pad != total:
            Qs = torch.cat([Qs, torch.full((n_pad - total, Qs.shape[1]), 1e12, device=dev)])
            out_ids = torch.cat(
                [out_ids, torch.full((n_pad - total,), -2, dtype=torch.int32, device=dev)]
            )
        total = Qs.shape[0]
    # the id each query excludes: shifted out of range when self matches
    # are allowed, negative (vote-dead) for pad rows either way
    q_rows = torch.where(out_ids >= 0, out_ids + (0 if exclude_self else n), out_ids)
    scatter_ids = torch.where(out_ids >= 0, out_ids, n).long()  # dead rows -> spill slot n
    out_d = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
    out_i = torch.zeros((n + 1, k), dtype=torch.int32, device=dev)
    seg = max(1, seg_rows // block) * block if total > seg_rows else total
    for a in range(0, total, seg):
        b = min(total, a + seg)
        Q_seg = X_exact[torch.clamp(out_ids[a:b], min=0).long()] if asym else Qs[a:b]
        r_seg, sid = q_rows[a:b], scatter_ids[a:b]
        if b - a < seg:  # pad the tail with dead queries
            pad = seg - (b - a)
            Q_seg = torch.cat([Q_seg, torch.full((pad, Q_seg.shape[1]), 1e12, device=dev)])
            r_seg = torch.cat([r_seg, torch.full((pad,), -2, dtype=torch.int32, device=dev)])
            sid = torch.cat([sid, torch.full((pad,), n, dtype=torch.int64, device=dev)])
        ds, is_ = _ivf_search_impl(Q_seg, r_seg, index, pos0=a, **search)
        out_d[sid] = ds
        out_i[sid] = is_
    return out_d[:n], out_i[:n]


def ivf_knn_queries(
    Q,
    index: IVFIndex,
    k: int = 15,
    nprobe: int = 12,
    query_ids=None,
    block: int = 256,
    m: Optional[int] = None,
    scan_precision: str = "high",
    budget: Optional[int] = None,
    scan_impl: str = "xla",
    merge: Optional[str] = None,
    seg_rows: int = 1 << 21,
    scan_fidelity: str = "full",
    nprobe_supers: Optional[int] = None,
    nomination: Optional[str] = None,
    sort_queries: bool = True,
    rerank: bool = True,
    budget_order: str = "depth",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of arbitrary query rows against a prebuilt IVF index.

    ``query_ids`` optionally carries one database id per query to exclude
    (self-exclusion when Q is part of the database). Queries are sorted by
    home cell first (``sort_queries``) so blocks stay cluster-coherent, and
    the block's probe count grows by the expected number of home cells per
    block. Returns ``(dists, indices)`` of shape ``(nq, k)`` in Q's row
    order; indices are int32 database ids. ``scan_precision``,
    ``scan_fidelity`` and ``scan_impl`` as in :func:`ivf_knn`.
    """
    _check_search_args(budget_order, scan_precision, scan_fidelity)
    n = index.n
    dev = index.X_sorted.device
    Q = torch.as_tensor(Q, dtype=torch.float32).to(dev)
    nq = Q.shape[0]
    nlist_t = int(index.centroids.shape[0])
    if sort_queries:
        homes_pb = int(np.ceil(block * min(nlist_t, max(1, nq)) / max(1, nq)))
        homes_pb = max(1, min(block, homes_pb))
    else:
        homes_pb = min(block, nlist_t)
    nprobe_eff = min(nlist_t, int(nprobe) * homes_pb)
    if homes_pb > 8 and nomination is None:
        # adjacency samples <= 8 home positions per block
        nomination = "flat"
    nprobe, budget, m_eff, merge, max_ch, scan_impl, _, nominate = _resolve_search_knobs(
        index, k, nprobe_eff, m, budget, merge, scan_impl, nprobe_supers, nomination,
        has_q_cells=sort_queries, rerank=rerank,
    )
    # cap the (block, budget · chunk) score buffer at ~1 GB, as the JAX
    # package does (it may fall below the max_ch + 1 floor: ROADMAP queue 3)
    budget = min(budget, max(nprobe, (1 << 30) // (block * index.chunk * 4)))
    chunk = index.chunk

    q_cells = None
    if sort_queries:
        labels = _assign_blockwise(Q, index.centroids)
        order = torch.argsort(labels, stable=True)
        Q = Q[order]
        q_cells = labels[order]
        if query_ids is not None:
            query_ids = torch.as_tensor(query_ids, dtype=torch.int32).to(dev)[order]
    if nominate == "adjacency" and q_cells is None:
        nominate = "flat"
    excl = (
        torch.as_tensor(query_ids, dtype=torch.int32).to(dev)
        if query_ids is not None else torch.full((nq,), n, dtype=torch.int32, device=dev)
    )
    n_pad = -(-nq // block) * block
    if q_cells is None:
        q_cells = torch.zeros((nq,), dtype=torch.int32, device=dev)
    if n_pad != nq:
        Q = torch.cat([Q, torch.full((n_pad - nq, Q.shape[1]), 1e12, device=dev)])
        excl = torch.cat([excl, torch.full((n_pad - nq,), -2, dtype=torch.int32, device=dev)])
        # the tail block's adjacency stays in the last home cell's neighbourhood
        q_cells = torch.cat([q_cells, q_cells[-1:].expand(n_pad - nq)])

    search = dict(k=k, ncells=nprobe, budget=budget, block=block, chunk=chunk, m=m_eff,
                  merge=merge, max_ch=max_ch, queries_raw=True, nominate=nominate,
                  rerank=rerank, budget_order=budget_order)
    d_parts, i_parts = [], []
    seg = max(block, (seg_rows // block) * block)
    for a in range(0, n_pad, seg):
        b = min(n_pad, a + seg)
        Q_seg, e_seg, c_seg = Q[a:b], excl[a:b], q_cells[a:b]
        if b - a < seg and n_pad > seg:  # pad the tail to the segment length
            pad = seg - (b - a)
            Q_seg = torch.cat([Q_seg, torch.full((pad, Q.shape[1]), 1e12, device=dev)])
            e_seg = torch.cat([e_seg, torch.full((pad,), -2, dtype=torch.int32, device=dev)])
            c_seg = torch.cat([c_seg, c_seg[-1:].expand(pad)])
        ds, is_ = _ivf_search_impl(Q_seg, e_seg, index, q_cells=c_seg, **search)
        d_parts.append(ds)
        i_parts.append(is_)
    d = torch.cat(d_parts)[:nq]
    i = torch.cat(i_parts)[:nq]
    if sort_queries:
        inv = torch.empty_like(order)
        inv[order] = torch.arange(nq, device=dev)
        d, i = d[inv], i[inv]
    return d, i
