"""IVF approximate kNN: coarse quantization + block-shared probe.

Counterpart of ``torchdr_tpu/ops/ivf.py``:

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
``topk``, ``sort`` and scatters; ``G`` is sized from the free
memory of the device. Each block keeps its own probe set, so the result is
that of one block at a time. Every shape inside the loop is fixed
(``budget``, ``ncells · max_ch``, ``n_home · P``), so the loop waits for
the device only where the tournament merge reads its count.

Storage tiers (``storage``), as in the JAX package:

- float32 rows (``"f32"``, and ``"auto"`` up to ``split_bytes``);
- the bf16 residual split (``"split"``, and ``"auto"`` past
  ``split_bytes``): ``X_sorted`` and ``X_lo`` hold bf16 hi and lo planes of
  the cell residual r = x − c_cell, ``xnorm2`` the exact float32 ‖x‖².
  The scan and the re-rank rebuild x = c + hi + lo in float32. The two
  planes take the bytes of one float32 row: on the card the split saves
  no memory (the JAX package splits past 4 GB because the TPU compiler
  fails on larger buffers; ROADMAP, "Quirks of the reference");
- int8 (``"int8"``): q = round(clip(r / s, ±127)) with per-cell-per-dim
  ``scales`` s, ¼ of float32's bytes, and ``xnorm2`` the norms of the
  reconstructed rows ‖c + s·q‖², so a scan score is the distance to the
  reconstructed row. ``scoring="asymmetric"`` scores the exact rows
  against it.

Nomination "supers" votes on the top-4 super-centroids of each query,
takes the ``nprobe_supers`` most voted supers and nominates among their
member cells, as the JAX package does; with fewer members than probed
cells it falls back to flat nomination.

:func:`ivf_build_from_batches` builds the same index from a batch feed
(``ops/loader.BatchSource``) in three passes: a training sample, the
assignment, and a write into the sorted layout on the host.

Deviations from the JAX package (ROADMAP queue 3):

- ``lax.approx_min_k`` becomes an exact ``torch.topk``, in the supers vote
  too. On the CPU, XLA's lowering of ``approx_min_k`` is exact too; on a
  TPU it is binned.
- Every product is full float32 (the entry points hold ``full_float32``):
  ``scan_precision`` takes the JAX package's names and changes nothing,
  where the JAX package votes
  and scans at ``Precision.HIGH``. A scan score is |x|² − 2 q·x in one
  product (``baddbmm``) with x rebuilt in float32 (c + hi + lo, c + hi
  under ``scan_fidelity="hi"``, c + s·q), where the JAX package sums
  q·c_cell, (q − c_home)·r and c_home·r, rounding q − c_home to a bf16
  pair for the split. Unknown values of both raise.
- Masked scores: a dead column carries MASK_VALUE in its norm and the
  excluded row gets it added at its column, where the JAX package adds it
  to every masked score; masked scores stay ≥ MASK_VALUE / 2 either way.
- The tournament merge takes the buffer's best m in one ``topk`` and
  merges slot by slot only the rows where a slot holds more than t of them
  (the same result: ``_tournament``); it reads that count once a group.
- ``scan_impl`` "xla", "slices" and "rows" run the same code. In the JAX
  package "slices" and "rows" exist only for TPU compiler limits on
  buffers over 4 GB (``ops/ivf.py:1148-1152, :1208-1211``).
- A block's probe votes are float32 sums in the order of its queries on
  the card too (``_votes``: a sorted, sequential scatter in place of
  atomic adds), so the card chooses the cells the CPU chooses from the
  same nominations. On the card, k-means sums are added by atomic
  operations whose order varies.
"""

from __future__ import annotations

import heapq
from typing import Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..base import resolve_device
from ..utils.wrappers import full_float32
from .distance import knn_graph
from .kmeans import kmeans_fit
from .metrics import MASK_VALUE

# rows of one host segment when a numpy dataset is assigned piecewise
_HOST_SEG_ROWS = 1 << 20
# headroom kept free on the card beside the build's permute and the search
_HEADROOM = 3 << 30


class IVFIndex(NamedTuple):
    centroids: torch.Tensor  # (ncells, d) float32
    # (n_pad + chunk, d) database rows grouped by cell: float32 rows, the
    # bf16 hi plane of the residual split, or int8 codes
    X_sorted: torch.Tensor
    ids_sorted: torch.Tensor  # (n_pad + chunk,) int32 original row ids (-1 padding)
    offsets: torch.Tensor  # (ncells,) int32 start of each cell in X_sorted
    counts: torch.Tensor  # (ncells,) int32 cell sizes
    chunk: int  # probe granularity (rows of one scan slot)
    n: int  # number of real database rows
    X_lo: Optional[torch.Tensor] = None  # bf16 lo plane of the residual split
    # (n_pad + chunk,) float32 |x|² (split) or |c + s·q|² (int8); pad rows |c|² or 0
    xnorm2: Optional[torch.Tensor] = None
    cells_sorted: Optional[torch.Tensor] = None  # (n_pad + chunk,) int32 cell of each row slot
    super_centroids: Optional[torch.Tensor] = None  # (S, d) means of the supers
    super_members: Optional[torch.Tensor] = None  # (S, W) int32 member cells, -1 padding
    cell_adj: Optional[torch.Tensor] = None  # (ncells, P) int32 nearest cells, self first
    scales: Optional[torch.Tensor] = None  # (ncells, d) float32 int8 dequantization scales


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


def _bf16_split(r: torch.Tensor):
    """(hi, lo) bf16 planes of float32 r, each rounded to nearest even:
    hi = bf16(r), lo = bf16(r − hi)."""
    hi = r.to(torch.bfloat16)
    return hi, (r - hi.to(torch.float32)).to(torch.bfloat16)


def _residual_split_device(x, cells, centroids, seg_bytes: int = 512 << 20):
    """Sorted float32 rows -> (r_hi, r_lo, xnorm2) of the residual split, on
    x's device, in row segments of ``seg_bytes`` (peak: x, both planes and
    one segment). Pad rows (x = 0) keep r = −c and a norm of 0."""
    n, d = x.shape
    step = min(n, max(1, seg_bytes // max(1, d * 4)))
    hi = torch.empty((n, d), dtype=torch.bfloat16, device=x.device)
    lo = torch.empty_like(hi)
    xn = torch.empty((n,), dtype=torch.float32, device=x.device)
    for a in range(0, n, step):
        xs = x[a : a + step]
        hi[a : a + step], lo[a : a + step] = _bf16_split(xs - centroids[cells[a : a + step].long()])
        xn[a : a + step] = torch.sum(xs * xs, dim=-1)
    return hi, lo, xn


def _int8_quantize_device(x, cells, centroids, ids, seg_bytes: int = 512 << 20):
    """Sorted float32 rows -> (q8, scales, xnorm2) of the int8 tier, on x's
    device, in two passes over row segments: per-(cell, dim) max |r| over
    the real rows (id >= 0), then q = round(clip(r / s, ±127)) with
    s = max(max |r|, 1e-12) / 127 and the norms of the reconstructed rows
    |c + s·q|². A scan score against exact norms with quantized cross terms
    carries a per-row bias; against these it is the squared distance to
    the reconstructed row."""
    n, d = x.shape
    nlist = centroids.shape[0]
    step = min(n, max(1, seg_bytes // max(1, d * 4)))
    amax = torch.zeros((nlist, d), dtype=torch.float32, device=x.device)
    for a in range(0, n, step):
        c = cells[a : a + step].long()
        r = torch.abs(x[a : a + step] - centroids[c])
        r = torch.where((ids[a : a + step] >= 0)[:, None], r, 0.0)
        amax.scatter_reduce_(0, c[:, None].expand(-1, d), r, reduce="amax")
    scales = torch.clamp(amax, min=1e-12) / 127.0
    q8 = torch.empty((n, d), dtype=torch.int8, device=x.device)
    xn = torch.empty((n,), dtype=torch.float32, device=x.device)
    for a in range(0, n, step):
        c = cells[a : a + step].long()
        cent, s = centroids[c], scales[c]
        q = torch.clamp(torch.round((x[a : a + step] - cent) / s), -127.0, 127.0)
        q8[a : a + step] = q.to(torch.int8)
        recon = cent + q * s
        xn[a : a + step] = torch.sum(recon * recon, dim=-1)
    return q8, scales, xn


def _int8_quantize_host(Xs_h, cells_h, cent_h, ids_h, offs_rows):
    """The int8 tier of a host (numpy) sorted layout. ``offs_rows`` are the
    cells' first layout rows; the per-cell max |r| is one
    ``np.maximum.reduceat`` over the sorted rows. Pad rows are zeroed in the
    residual first (their q is 0, their norm |c|²); an empty cell takes a
    neighbouring row's scales, and is never probed."""
    R = Xs_h - cent_h[cells_h]
    R[ids_h < 0] = 0.0
    idx = np.minimum(offs_rows, max(0, R.shape[0] - 1)).astype(np.intp)
    scales = np.maximum.reduceat(np.abs(R), idx, axis=0).astype(np.float32)
    scales = np.maximum(scales, 1e-12) / 127.0
    q8 = np.clip(np.round(R / scales[cells_h]), -127, 127).astype(np.int8)
    recon = cent_h[cells_h] + q8.astype(np.float32) * scales[cells_h]
    xn = np.einsum("ij,ij->i", recon, recon).astype(np.float32)
    return q8, scales, xn


def _store_tier(Xs, storage: str, want_split: bool, cells_h, centroids, ids_h, offs_h, dev):
    """(X_sorted, X_lo, xnorm2, scales) on ``dev`` from the sorted float32
    layout ``Xs``: a tensor (the tier is built on its device) or a numpy
    array (built on the host; only the stored planes cross to ``dev``)."""
    X_lo = xnorm2 = scales = None
    if isinstance(Xs, np.ndarray):
        if storage == "int8":
            q8, s, xn = _int8_quantize_host(
                Xs, cells_h, centroids.cpu().numpy().astype(np.float32), ids_h, offs_h
            )
            return (torch.from_numpy(q8).to(dev), None, torch.from_numpy(xn).to(dev),
                    torch.from_numpy(s).to(dev))
        if want_split:
            hi, lo, xn = _residual_split_device(
                torch.from_numpy(Xs), torch.from_numpy(cells_h), centroids.cpu()
            )
            return hi.to(dev), lo.to(dev), xn.to(dev), None
        return torch.from_numpy(Xs).to(dev), None, None, None
    if storage == "int8":
        Xs, scales, xnorm2 = _int8_quantize_device(
            Xs, torch.from_numpy(cells_h).to(dev), centroids, torch.from_numpy(ids_h).to(dev)
        )
    elif want_split:
        Xs, X_lo, xnorm2 = _residual_split_device(Xs, torch.from_numpy(cells_h).to(dev), centroids)
    return Xs, X_lo, xnorm2, scales


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


@full_float32()
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
    ``storage``: "f32" float32 rows; "split" the bf16 residual split;
    "int8" the int8 tier; "auto" float32 up to ``split_bytes`` of sorted
    rows and the split past it (module docstring). "split" and "int8" need
    ``align=True``. The tiers are built where the rows are permuted: on
    the device, or on the host for a numpy dataset too large for it.

    The random draws come from ``generator`` (default: seeded with 0).
    ``train_idx`` (the k-means sample's rows), ``init_centers`` (its
    seeding) and ``super_init`` (the supers' seeding) take given draws.
    """
    if storage not in ("auto", "f32", "split", "int8"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown storage {storage!r}")
    if storage in ("split", "int8") and not align:
        raise ValueError(
            f"[TorchDR-Torch] ERROR : storage={storage!r} needs the chunk-aligned "
            "layout (align=True)."
        )
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
    want_split = storage == "split" or (storage == "auto" and (total + chunk) * d * 4 > split_bytes)
    cells_h = _cells_of_layout(padded, chunk, nlist)
    dest_src = np.empty((n,), np.int64)
    dest_src[order_h] = dest_h  # row j of X lands at dest_src[j]
    ids_h = np.full((total + chunk,), -1, np.int32)
    ids_h[dest_h] = order_h
    if not is_host:
        X_sorted = torch.zeros((total + chunk, d), dtype=torch.float32, device=dev)
        X_sorted.index_copy_(0, torch.from_numpy(dest_src).to(dev), X)
    else:
        # host permutation: only the stored planes cross to the card
        X_sorted = torch.zeros((total + chunk, d), dtype=torch.float32)
        X_sorted.index_copy_(
            0, torch.from_numpy(dest_src), torch.from_numpy(np.ascontiguousarray(X, np.float32))
        )
        X_sorted = X_sorted.numpy()
    del X  # a copy this build pushed goes before the tiers add their planes
    X_sorted, X_lo, xnorm2, scales = _store_tier(
        X_sorted, storage, want_split, cells_h, centroids, ids_h, offs_h, dev
    )
    return IVFIndex(
        centroids, X_sorted, torch.from_numpy(ids_h).to(dev),
        torch.from_numpy(offs_h.astype(np.int32)).to(dev), counts, chunk, n,
        X_lo=X_lo, xnorm2=xnorm2, cells_sorted=torch.from_numpy(cells_h).to(dev),
        super_centroids=supers, super_members=members, cell_adj=cell_adj, scales=scales,
    )


def _field_tensor(v, device) -> torch.Tensor:
    """One index field as a tensor on ``device``: bf16 and int8 planes keep
    their dtype, other floats become float32 and other integers int32."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        a = np.ascontiguousarray(np.array(v))
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as a JAX array reads
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if t.dtype in (torch.bfloat16, torch.int8):
        dtype = t.dtype
    else:
        dtype = torch.float32 if t.is_floating_point() else torch.int32
    return t.to(device=device, dtype=dtype)


def index_from_numpy(fields: Union[Mapping, NamedTuple], device="auto") -> IVFIndex:
    """An :class:`IVFIndex` on ``device`` ("auto": the card, raising without
    one) from the fields of an index given as arrays or tensors (a mapping,
    or a ``NamedTuple`` such as the JAX package's ``IVFIndex`` or this
    one): the bf16 planes of the residual split and int8 codes keep their
    dtype, other float fields become float32 tensors, integer fields
    int32, ``chunk`` and ``n`` ints. Anything ``np.asarray`` reads is taken,
    ml_dtypes' bfloat16 too."""
    device = resolve_device(device)
    fields = dict(fields._asdict() if hasattr(fields, "_asdict") else fields)
    out = {}
    for name in IVFIndex._fields:
        v = fields.get(name)
        if name in ("chunk", "n"):
            out[name] = int(v)
        elif v is not None:
            out[name] = _field_tensor(v, device)
    return IVFIndex(**out)


def _resolve_search_knobs(index, k, nprobe, m, budget, merge, scan_impl,
                          nprobe_supers=None, nomination=None,
                          has_q_cells=False, rerank=True):
    """Resolve the data-dependent search knobs for an index: (nprobe,
    budget, m_eff, merge, max_ch, scan_impl, n_supers, nominate), with
    the JAX package's arithmetic and its rules: ``nprobe_supers`` counts
    only on an index with supers and makes "supers" the default
    nomination; compressed indexes (split, int8) merge by "tournament";
    an approx merge keeps m ≥ 64 over a split index; a float32 index over
    4 GB reports ``scan_impl`` "slices" (which runs the same code here)."""
    if scan_impl not in ("xla", "slices", "rows"):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : unknown scan_impl {scan_impl!r} "
            "(choose 'xla', 'slices' or 'rows')."
        )
    if nomination not in (None, "flat", "adjacency", "supers"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown ivf nomination {nomination!r}")
    if merge not in (None, "approx", "exact", "tournament"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown ivf merge {merge!r}")
    chunk = index.chunk
    nlist_total = int(index.centroids.shape[0])
    n_supers = 0 if nprobe_supers is None or index.super_centroids is None else int(nprobe_supers)
    if nomination is None:
        adj_ok = index.cell_adj is not None and (index.cells_sorted is not None or has_q_cells)
        if n_supers > 0:
            nomination = "supers"
        elif adj_ok and nlist_total >= 1024:
            nomination = "adjacency"
        else:
            nomination = "flat"
    if merge is None:
        compressed = index.X_lo is not None or index.scales is not None
        merge = "tournament" if compressed else "approx"
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
        m_eff = max(2 * k, 64 if index.X_lo is not None else 32)
    nbytes = index.X_sorted.numel() * index.X_sorted.element_size()
    if nbytes > (4 << 30) and scan_impl == "xla":
        scan_impl = "slices"
    return nprobe, budget, m_eff, merge, max_ch, scan_impl, n_supers, nomination


def _group_size(device: torch.device, per_block_bytes: int, n_blocks: int) -> int:
    """Blocks run at once: an eighth of the card's free memory (64 MB on
    the CPU) over one block's transient bytes, at most 256."""
    if device.type == "cuda":
        room = max(0, _permute_hbm_budget(device)) // 8
    else:
        room = 64 << 20
    return int(max(1, min(n_blocks, 256, room // max(1, per_block_bytes))))


def _votes(nom: torch.Tensor, weights: torch.Tensor, alive: torch.Tensor, n_targets: int):
    """(g, n_targets) float32 vote totals: each live query of a block gives
    its r-th nominee (``nom``: (g, block, R)) the rank weight
    ``weights[r]`` = 1 / (1 + r). Each total is a float32 sum in the order
    of the queries, as the JAX package's CPU scatter-add takes them: an
    accumulating ``index_put_`` adds sequentially on the CPU and, on the
    card, in the order of a stable sort of the targets, so both devices
    round alike and the sum is the same on every run."""
    g = nom.shape[0]
    flat = (torch.arange(g, device=nom.device)[:, None, None] * n_targets + nom).reshape(-1)
    w = (alive.to(torch.float32)[:, :, None] * weights).reshape(-1)
    votes = torch.zeros((g * n_targets,), dtype=torch.float32, device=nom.device)
    votes.index_put_((flat,), w, accumulate=True)
    return votes.reshape(g, n_targets)


def _mask_excluded(buf, rows, pos_of_id, slot_start, slot_valid, sel_live, chunk: int):
    """Add MASK_VALUE to each query's score of its excluded row, where a
    live slot holds it: the column whose id equals ``rows`` (ids outside
    [0, n) exclude nothing). ``buf`` is (g, block, n_slots · chunk)."""
    g, block, W = buf.shape
    n = pos_of_id.shape[0] - 1
    e_pos = pos_of_id[torch.where((rows >= 0) & (rows < n), rows, n).long()]  # (g, block)
    off = e_pos[:, :, None] - slot_start[:, None, :]  # (g, block, n_slots)
    hit = sel_live[:, None, :] & (e_pos[:, :, None] >= 0) & (off >= 0) & (
        off < torch.clamp(slot_valid, max=chunk)[:, None, :])
    j = torch.argmax(hit.to(torch.int8), dim=2, keepdim=True)
    col = (j * chunk + torch.gather(off, 2, j))[..., 0]
    flat = (torch.arange(g * block, device=buf.device) * W + col.reshape(-1))[hit.any(2).reshape(-1)]
    buf.view(-1)[flat] += MASK_VALUE


def _tournament(buf: torch.Tensor, chunk: int, t: int, m: int):
    """The JAX package's tournament merge of a (g, block, W) score buffer:
    each slot's (``chunk`` columns) best t, then the best m of those
    survivors; exact for k <= t. It is the buffer's best m wherever no
    slot holds more than t of them, so it is taken so (one ``topk``), and
    only the rows where a slot does are merged slot by slot. Reading those
    rows' count waits for the device once a call."""
    g, block, W = buf.shape
    nsl = W // chunk
    mm = min(m, nsl * t)
    vals, cidx = torch.topk(buf, mm, dim=2, largest=False)
    if mm <= t:
        return vals, cidx
    slots = torch.sort(cidx // chunk, dim=2).values
    over = torch.nonzero((slots[..., t:] == slots[..., : mm - t]).any(2).reshape(-1))[:, 0]
    if over.numel():
        sub = buf.reshape(g * block, nsl, chunk)[over]
        v1, i1 = torch.sort(sub, dim=2)
        v2, i2 = torch.topk(v1[..., :t].reshape(-1, nsl * t), mm, dim=1, largest=False)
        within = torch.gather(i1[..., :t].reshape(-1, nsl * t), 1, i2)
        vals.view(-1, mm)[over] = v2
        cidx.view(-1, mm)[over] = (i2 // t) * chunk + within
    return vals, cidx


def _top_cells(score: torch.Tensor, ncells: int):
    """The ``ncells`` largest scores of each row, equal scores in index
    order as ``lax.top_k`` takes them: a vote total outweighs the distance
    term, so cells with equal votes tie exactly."""
    v, i = torch.sort(score, dim=1, descending=True, stable=True)
    return v[:, :ncells], i[:, :ncells]


def _ivf_search_impl(
    Qs, q_rows, index: IVFIndex, k, ncells, budget, block, chunk, m, max_ch,
    merge="approx", pos0=0, queries_raw=False, nominate="flat",
    q_cells=None, rerank=True, budget_order="depth", Qs_lo=None,
    scan_fidelity="full", n_supers=0, queries_exact=False,
):
    """The probe over ``Qs`` (nq, d), nq a multiple of ``block``: returns
    (dists, ids) of shape (nq, k), ids int32. ``q_rows`` is the id each
    query must not return (negative: a dead query, which does not vote).
    Self queries sit at absolute layout position ``pos0 + i``: under the
    split and int8 tiers they are the stored rows (``Qs_lo`` the lo plane's
    slice), rebuilt as c + hi + lo or c + s·q, unless ``queries_exact``
    says the caller gathered the exact rows. Raw queries carry their home
    cells in ``q_cells``."""
    centroids, X_sorted, ids_sorted = index.centroids, index.X_sorted, index.ids_sorted
    offsets, counts, cells_sorted, cell_adj = (
        index.offsets.long(), index.counts, index.cells_sorted, index.cell_adj
    )
    X_lo, xnorm2, scales = index.X_lo, index.xnorm2, index.scales
    residual, int8 = xnorm2 is not None, scales is not None
    dev = Qs.device
    use_supers = nominate == "supers" and n_supers > 0 and index.super_centroids is not None
    if use_supers:
        super_centroids, super_members = index.super_centroids, index.super_members
        S, memb_w = super_members.shape
        n_supers = min(n_supers, S)
        s_norm = torch.sum(super_centroids * super_centroids, dim=-1)
        k_sup = min(4, S)
        w_sup = 1.0 / (1.0 + torch.arange(k_sup, dtype=torch.float32, device=dev))
        if n_supers * memb_w < ncells or n_supers >= S:
            use_supers = False  # member union too thin to pick ncells cells
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
    if int8 and not aligned:
        raise NotImplementedError("[TorchDR-Torch] int8 storage requires the chunk-aligned layout.")
    lo_scan = X_lo is not None and scan_fidelity == "full"
    if aligned:
        X_r = X_sorted[:n_total].reshape(n_total // chunk, chunk, d)
        ids_r = ids_sorted[:n_total].reshape(n_total // chunk, chunk)
        if residual:
            xn_r = xnorm2[:n_total].reshape(n_total // chunk, chunk)
        if lo_scan:
            X_lo_r = X_lo[:n_total].reshape(n_total // chunk, chunk, d)
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
    elif use_supers:
        n_cand = n_supers * memb_w
    else:
        n_cand = nlist
    W = n_slots * chunk
    # the score buffer and the rows in float32, besides smaller buffers
    per_block = 4 * block * (2 * W + 3 * n_cand + m * (d + 4) + 3 * n_slots) + 4 * W * (2 * d + 4)
    G = _group_size(dev, per_block, n_blocks)

    def rows_f32(pos):
        """Database rows at layout positions ``pos`` in float32: c + hi + lo
        under the split, c + s·q under int8."""
        Xg = X_sorted[pos].to(torch.float32)
        if residual:
            cp = cells_sorted[pos].long()
        if int8:
            Xg = Xg * scales[cp]
        if X_lo is not None:
            Xg = Xg + X_lo[pos].to(torch.float32)
        if residual:
            Xg = Xg + centroids[cp]
        return Xg

    # the layout position of each id (-1: none), for the excluded rows
    live_rows = torch.nonzero(ids_sorted >= 0).reshape(-1)
    pos_of_id = torch.full((index.n + 1,), -1, dtype=torch.int64, device=dev)
    pos_of_id[ids_sorted[live_rows].long()] = live_rows

    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    for b0 in range(0, n_blocks, G):
        g = min(G, n_blocks - b0)
        r0, r1 = b0 * block, (b0 + g) * block
        Qb = Qs[r0:r1].to(torch.float32)
        if Qs_lo is not None:
            Qb = Qb + Qs_lo[r0:r1].to(torch.float32)
        if residual and not queries_raw and not queries_exact:
            # self queries are stored rows: add back their scale and centroid
            q_pos = torch.clamp(pos0 + torch.arange(r0, r1, device=dev),
                                max=cells_sorted.shape[0] - 1)
            qc = cells_sorted[q_pos].long()
            if int8:
                Qb = Qb * scales[qc]
            Qb = Qb + centroids[qc]
        Qb = Qb.reshape(g, block, d)
        rows = q_rows[r0:r1].reshape(g, block)
        qn = torch.sum(Qb * Qb, dim=-1)  # (g, block)
        alive = rows >= 0  # dead queries do not vote
        blk = torch.arange(b0, b0 + g, device=dev)
        members = None
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
        elif use_supers:
            # the block's most voted supers, then their member cells
            gqs = torch.matmul(Qb, super_centroids.T)  # (g, block, S)
            Dcs = torch.clamp(qn[:, :, None] + s_norm - 2.0 * gqs, min=0.0)
            nom_s = torch.topk(Dcs, k_sup, dim=2, largest=False).indices
            votes_s = _votes(nom_s, w_sup, alive, S) - torch.min(Dcs, dim=1).values / 1e12
            top_s = _top_cells(votes_s, n_supers)[1]
            members = super_members[top_s].reshape(g, -1).long()  # -1 pads
        if members is not None:
            mvalid = members >= 0
            mem = torch.clamp(members, min=0)
            gq_m = torch.bmm(Qb, centroids[mem].transpose(1, 2))  # (g, block, M)
            Dc = torch.clamp(qn[:, :, None] + c_norm[mem][:, None, :] - 2.0 * gq_m, min=0.0)
            Dc = Dc + MASK_VALUE * (~mvalid)[:, None, :].to(Dc.dtype)
            nom = torch.topk(Dc, per_query_probes, dim=2, largest=False).indices
            votes = torch.where(mvalid, _votes(nom, weights, alive, mem.shape[1]), -1.0)
            score = votes - torch.min(Dc, dim=1).values / 1e12
            sv, msel = _top_cells(score, ncells)
            cells = torch.gather(mem, 1, msel)
            cells_valid = sv > -0.5
        else:
            gq = torch.matmul(Qb, centroids.T)  # (g, block, nlist)
            Dc = torch.clamp(qn[:, :, None] + c_norm - 2.0 * gq, min=0.0)
            nom = torch.topk(Dc, per_query_probes, dim=2, largest=False).indices
            score = _votes(nom, weights, alive, nlist) - torch.min(Dc, dim=1).values / 1e12
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

        if residual:
            # the slots' rows rebuilt in float32, c + hi (+ lo) or c + s·q: a
            # slot never crosses cells (aligned layout), so one centroid and
            # one scale row serve each slot
            slot_cells = torch.gather(cells, 1, sel_ci)  # (g, n_slots)
            Xg = Xg_all.to(torch.float32).reshape(g, n_slots, chunk, d)
            if int8:
                Xg = Xg * scales[slot_cells][:, :, None, :]
            if lo_scan:
                lo = X_lo_r[cid] if aligned else X_lo[row_idx]
                Xg = Xg + lo.reshape(g, n_slots, chunk, d).to(torch.float32)
            Xg = (Xg + centroids[slot_cells][:, :, None, :]).reshape(g, W, d)
            ncol = (xn_r[cid] if aligned else xnorm2[row_idx]).reshape(g, W)
        else:
            Xg = Xg_all
            ncol = torch.sum(Xg * Xg, dim=-1)  # (g, W)
        # |x|² − 2 q·x in one product; dead columns carry the mask in their
        # norm, and each query's excluded row gets it after
        ncol = torch.where(idg < 0, ncol + MASK_VALUE, ncol)
        buf = torch.baddbmm(ncol[:, None, :], Qb, Xg.transpose(1, 2), alpha=-2.0)
        del Xg
        _mask_excluded(buf, rows, pos_of_id, slot_start, slot_valid, sel_live, chunk)
        if merge == "tournament":
            vals, cidx = _tournament(buf, chunk, min(chunk, max(16, k)), m)
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
            diff = Qb[:, :, None, :] - rows_f32(pos)  # (g, block, m, d)
            D2 = torch.sum(diff * diff, dim=-1)
            D2 = torch.where(vals >= MASK_VALUE * 0.5, MASK_VALUE, D2)
            D2, sel = torch.topk(D2, k, dim=2, largest=False)
            ids = ids_sorted[torch.gather(pos, 2, sel)]
        out_d[r0:r1] = D2.reshape(-1, k)
        out_i[r0:r1] = ids.reshape(-1, k)
    return out_d, out_i


def _check_search_args(budget_order, scan_precision, scan_fidelity, scoring=None):
    """Reject unknown option values. ``scan_precision`` takes the JAX
    package's three names: every product here is full float32, as exact as
    the most exact of them. ``scan_fidelity`` "hi" scans the split tier's
    hi plane alone; the other tiers have no lo plane to drop, and there
    "full" and "hi" are the same search, in the JAX package too."""
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


@full_float32()
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
    gather), rebuilt from the split or int8 planes, in segments of
    ``seg_rows``; dead layout rows ride along as dead queries and land on a
    spill slot. ``rerank=False`` returns the scan scores assembled into
    distances (selection at width k). ``scoring="asymmetric"`` scores X's
    exact rows, gathered into layout order a segment at a time, against
    the stored ones (under int8 storage the Faiss ADC convention; the same
    numbers for float32). ``scan_precision`` and ``scan_impl`` take the JAX
    package's values and each gives the same result for every one of them;
    ``scan_fidelity="hi"`` scans the split tier's hi plane alone (module
    docstring, ``_check_search_args``); other values raise.
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
    nprobe, budget, m_eff, merge, max_ch, scan_impl, n_supers, nominate = _resolve_search_knobs(
        index, k, nprobe, m, budget, merge, scan_impl, nprobe_supers, nomination, rerank=rerank,
    )
    chunk = index.chunk
    search = dict(k=k, ncells=nprobe, budget=budget, block=block, chunk=chunk, m=m_eff,
                  merge=merge, max_ch=max_ch, nominate=nominate, rerank=rerank,
                  budget_order=budget_order, scan_fidelity=scan_fidelity, n_supers=n_supers,
                  queries_exact=asym)

    total = index.X_sorted.shape[0] - chunk
    Qs, Qs_lo, out_ids = index.X_sorted, index.X_lo, index.ids_sorted
    if (total + chunk) % block == 0:
        total = total + chunk  # the queries are the stored planes, not a copy
    else:
        n_pad = -(-total // block) * block
        Qs, out_ids = Qs[:total], out_ids[:total]
        Qs_lo = None if Qs_lo is None else Qs_lo[:total]
        if n_pad != total:
            Qs, Qs_lo, out_ids = _pad_queries(Qs, Qs_lo, out_ids, n_pad - total)
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
        if asym:  # the exact rows of this segment; dead rows gather row 0
            Q_seg, Ql_seg = X_exact[torch.clamp(out_ids[a:b], min=0).long()], None
        else:
            Q_seg, Ql_seg = Qs[a:b], None if Qs_lo is None else Qs_lo[a:b]
        r_seg = q_rows[a:b]
        sid = scatter_ids[a:b]
        if b - a < seg:  # pad the tail with dead queries
            Q_seg, Ql_seg, r_seg = _pad_queries(Q_seg, Ql_seg, r_seg, seg - (b - a))
            sid = torch.cat([sid, torch.full((seg - (b - a),), n, dtype=torch.int64, device=dev)])
        ds, is_ = _ivf_search_impl(Q_seg, r_seg, index, pos0=a, Qs_lo=Ql_seg, **search)
        out_d[sid] = ds
        out_i[sid] = is_
    return out_d[:n], out_i[:n]


def _pad_queries(Q, Q_lo, ids, pad: int):
    """``pad`` dead queries appended: rows of 1e12 (0 in int8 codes, whose
    rebuilt row is the cell's centroid), a zero lo plane, id −2."""
    fill = 0 if Q.dtype == torch.int8 else 1e12
    Q = torch.cat([Q, torch.full((pad, Q.shape[1]), fill, dtype=Q.dtype, device=Q.device)])
    if Q_lo is not None:
        Q_lo = torch.cat([Q_lo, Q_lo.new_zeros((pad, Q_lo.shape[1]))])
    ids = torch.cat([ids, torch.full((pad,), -2, dtype=torch.int32, device=ids.device)])
    return Q, Q_lo, ids


@full_float32()
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
    order; indices are int32 database ids. The queries are exact rows:
    against a split or int8 index they are scored as they are (the JAX
    package's cross-query path is asymmetric too). ``scan_precision``,
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
    nprobe, budget, m_eff, merge, max_ch, scan_impl, n_supers, nominate = _resolve_search_knobs(
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
                  rerank=rerank, budget_order=budget_order, scan_fidelity=scan_fidelity,
                  n_supers=n_supers)
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


@full_float32()
def ivf_build_from_batches(
    batches,
    n_clusters: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    train_size: int = 25_600,
    kmeans_iters: int = 25,
    chunk: Optional[int] = None,
    verbose: bool = False,
    split_bytes: int = 4 << 30,
    n_superlist: Optional[int] = None,
    storage: str = "auto",
    device="auto",
    train_rows=None,
    init_centers=None,
    super_init=None,
) -> IVFIndex:
    """Build the aligned IVF index from a batch feed, never holding the
    unsorted dataset.

    ``batches`` is anything :class:`~torchdr_tpu_torch.ops.loader.BatchSource`
    takes. Three passes: a training sample (a proportional share of each
    batch, drawn by numpy from a seed that ``generator`` draws; or the
    given global ``train_rows``), the assignment of each batch on
    ``device`` (only labels come back), and a write of each batch into its
    slots of the sorted layout on the host. A replayed source is read
    again on each pass, so the host holds the sorted layout and one batch;
    a pass that yields other rows raises. Every storage tier of
    :func:`ivf_build` is built, on the host, and the stored planes are
    pushed to ``device``. ``init_centers`` and ``super_init`` take given
    k-means seedings.
    """
    from .loader import BatchSource

    if storage not in ("auto", "f32", "split", "int8"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown storage {storage!r}")
    dev = resolve_device(device)
    src = BatchSource(batches)
    n, d = src.shape_hint()
    nlist = n_clusters or auto_nlist(n)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    if chunk is None:
        mean_cell = max(1, n // max(1, nlist))
        chunk = int(min(512, max(64, -(-int(1.3 * mean_cell) // 64) * 64)))
    chunk = min(chunk, max(64, n))

    # pass 1: the training sample, a proportional share of every batch
    train_size = min(n, max(train_size, 64 * nlist))
    parts, row0 = [], 0
    if train_rows is None:
        seed = int(torch.randint(0, 1 << 30, (1,), generator=generator, device=generator.device))
        rng = np.random.default_rng(seed)
        for b in src:
            take = max(1, int(round(train_size * b.shape[0] / n)))
            parts.append(b[np.sort(rng.choice(b.shape[0], min(take, b.shape[0]), replace=False))])
    else:
        want = np.sort(np.asarray(train_rows, np.int64))
        for b in src:
            sel = want[(want >= row0) & (want < row0 + b.shape[0])] - row0
            parts.append(b[sel])
            row0 += b.shape[0]
    train = torch.from_numpy(np.concatenate(parts)[:train_size]).to(dev)
    del parts
    centroids, _, _ = kmeans_fit(
        train, nlist, generator, max_iter=kmeans_iters,
        init="random" if nlist >= 2048 else "++", init_centers=init_centers,
    )
    del train

    if n_superlist is None:
        n_superlist = max(32, nlist // 64) if nlist >= 1024 else 0
    if n_superlist and n_superlist < nlist:
        perm_s, supers, members = _build_supers(centroids, int(n_superlist), generator, super_init)
        centroids = centroids[torch.from_numpy(perm_s).to(dev)]
    else:
        supers = members = None
    cell_adj = _build_cell_adjacency(centroids)

    # pass 2: the assignment of every batch (only labels come back)
    labels_per_batch = [_assign_host_segmented(b, centroids) for b in src]
    counts_h = np.zeros((nlist,), np.int64)
    for lab in labels_per_batch:
        counts_h += np.bincount(lab, minlength=nlist)
    if int(counts_h.sum()) != n:
        raise ValueError(
            "[TorchDR-Torch] ERROR : batch feed yielded "
            f"{int(counts_h.sum())} rows on the assignment pass but "
            f"{n} rows were expected — the source must produce the same "
            "batches on every pass (shuffle=False, deterministic factory)."
        )

    padded = np.ceil(counts_h / chunk).astype(np.int64) * chunk
    offs_h = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    total = int(padded.sum())

    # pass 3: each batch straight into its sorted slots
    Xs_h = np.zeros((total + chunk, d), np.float32)
    ids_h = np.full((total + chunk,), -1, np.int32)
    fill = offs_h.copy()  # next free slot of each cell
    row0 = 0
    for b_arr, lab in zip(src, labels_per_batch):
        if b_arr.shape[0] != lab.shape[0]:
            raise ValueError(
                f"[TorchDR-Torch] ERROR : write pass saw a batch of {b_arr.shape[0]} rows "
                f"where the assignment pass saw {lab.shape[0]} — the batch feed must "
                "replay identically on every pass."
            )
        order = np.argsort(lab, kind="stable")
        lab_s = lab[order]
        cell_ids, run_starts = np.unique(lab_s, return_index=True)
        run_ends = np.append(run_starts[1:], lab_s.shape[0])
        within = np.arange(lab_s.shape[0]) - run_starts[np.searchsorted(cell_ids, lab_s)]
        dest = fill[lab_s] + within
        fill[cell_ids] += run_ends - run_starts
        Xs_h[dest] = b_arr[order]
        ids_h[dest] = row0 + order.astype(np.int32)
        row0 += b_arr.shape[0]
    if row0 != n:
        raise ValueError(
            f"[TorchDR-Torch] ERROR : write pass saw {row0} rows, expected "
            f"{n} — the batch feed must replay identically on every pass."
        )

    cells_h = _cells_of_layout(padded, chunk, nlist)
    want_split = storage == "split" or (storage == "auto" and (total + chunk) * d * 4 > split_bytes)
    X_sorted, X_lo, xnorm2, scales = _store_tier(
        Xs_h, storage, want_split, cells_h, centroids, ids_h, offs_h, dev
    )
    return IVFIndex(
        centroids, X_sorted, torch.from_numpy(ids_h).to(dev),
        torch.from_numpy(offs_h.astype(np.int32)).to(dev),
        torch.from_numpy(counts_h.astype(np.int32)).to(dev), chunk, n,
        X_lo=X_lo, xnorm2=xnorm2, cells_sorted=torch.from_numpy(cells_h).to(dev),
        super_centroids=supers, super_members=members, cell_adj=cell_adj, scales=scales,
    )
