"""Product quantization, the compressed-memory kNN tier (counterpart of
``torchdr_tpu/ops/pq.py``).

- :func:`pq_train`: 256 codewords for each of M subspaces of d / M
  columns, each by the port's ``kmeans_fit``.
- :func:`pq_encode`: each row's nearest codeword in every subspace, in row
  blocks: (n, M) uint8 codes, 16 bytes a row at M = 16.
- :func:`pq_search`: asymmetric distance computation (ADC), brute force
  over every code. A query block's (block, M, 256) table of
  query-to-codeword distances is one batched product; a database chunk's
  scores are M column gathers from it, merged into a running top-k.

ADC ranks by the quantized distance, which caps recall well below the
exact and IVF tiers; ``refine_from`` re-ranks the top candidates against
exact rows. The scan reads n² · M table entries: it is the memory tier,
not the speed tier.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..base import resolve_device
from .kmeans import kmeans_fit
from .metrics import MASK_VALUE


class PQCodebook(NamedTuple):
    codebooks: torch.Tensor  # (M, 256, dsub) float32
    M: int
    dsub: int


def _as_rows(X, device) -> torch.Tensor:
    """X as a float32 tensor: a tensor stays on its device, numpy goes to
    ``device`` ("auto": the card)."""
    if isinstance(X, torch.Tensor):
        return X.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(resolve_device(device))


def pq_train(
    X_train,
    M: int = 16,
    generator: Optional[torch.Generator] = None,
    kmeans_iters: int = 20,
    init_centers=None,
    device="auto",
) -> PQCodebook:
    """Per-subspace codebooks of 256 codewords, k-means++ seeded from
    ``generator`` (default: seeded with 0), or from the given (M, 256,
    dsub) ``init_centers``."""
    X_train = _as_rows(X_train, device)
    n, d = X_train.shape
    if d % M != 0:
        raise ValueError(f"[TorchDR-Torch] ERROR : d={d} not divisible by M={M}.")
    dsub = d // M
    if generator is None:
        generator = torch.Generator(device=X_train.device)
        generator.manual_seed(0)
    sub = X_train.reshape(n, M, dsub).transpose(0, 1)  # (M, n, dsub)
    codebooks = torch.stack([
        kmeans_fit(sub[m].contiguous(), 256, generator, max_iter=kmeans_iters,
                   init_centers=None if init_centers is None else init_centers[m])[0]
        for m in range(M)
    ])
    return PQCodebook(codebooks, M, dsub)


def pq_encode(X, cb: PQCodebook, block: int = 8192, device="auto") -> torch.Tensor:
    """(n, M) uint8 codes of X's rows, ``block`` rows at a time."""
    X = _as_rows(X, device)
    n = X.shape[0]
    books = cb.codebooks.to(X.device)
    M, dsub = books.shape[0], books.shape[2]
    c_norm = torch.sum(books * books, dim=-1)  # (M, 256)
    codes = torch.empty((n, M), dtype=torch.uint8, device=X.device)
    for a in range(0, n, block):
        sub = X[a : a + block].reshape(-1, M, dsub)
        gram = torch.einsum("bmd,mcd->bmc", sub, books)
        codes[a : a + block] = torch.argmin(c_norm[None] - 2.0 * gram, dim=-1).to(torch.uint8)
    return codes


def pq_search(
    Q,
    codes: torch.Tensor,
    cb: PQCodebook,
    k: int = 15,
    exclude_rows=None,
    block: int = 256,
    db_chunk: int = 65_536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC brute-force search of PQ codes: the k smallest quantized
    distances of each query (less its own |q|², constant per row) and
    their int32 row ids. ``exclude_rows[i]`` masks one database row for
    query i (self exclusion)."""
    Q = _as_rows(Q, codes.device)
    nq, n = Q.shape[0], codes.shape[0]
    books = cb.codebooks.to(Q.device)
    M, dsub = books.shape[0], books.shape[2]
    c_norm = torch.sum(books * books, dim=-1)  # (M, 256)
    excl = (torch.full((nq,), -1, dtype=torch.int64, device=Q.device) if exclude_rows is None
            else torch.as_tensor(exclude_rows, device=Q.device).long())
    out_d = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    for a in range(0, nq, block):
        Qb = Q[a : a + block]
        rows = excl[a : a + block]
        b = Qb.shape[0]
        lut = c_norm[None] - 2.0 * torch.einsum("bmd,mcd->bmc", Qb.reshape(b, M, dsub), books)
        best_d = torch.full((b, k), MASK_VALUE, dtype=torch.float32, device=Q.device)
        best_i = torch.full((b, k), -1, dtype=torch.int64, device=Q.device)
        for c0 in range(0, n, db_chunk):
            Cc = codes[c0 : c0 + db_chunk].long()
            cols = torch.arange(c0, c0 + Cc.shape[0], device=Q.device)
            # sum over m of lut[q, m, code[c, m]]: M column gathers
            D = lut[:, 0, :][:, Cc[:, 0]]
            for mi in range(1, M):
                D = D + lut[:, mi, :][:, Cc[:, mi]]
            D = D + MASK_VALUE * (cols[None, :] == rows[:, None]).to(D.dtype)
            cand_d = torch.cat([best_d, D], dim=1)
            cand_i = torch.cat([best_i, cols.expand(b, -1)], dim=1)
            best_d, sel = torch.topk(cand_d, k, dim=1, largest=False)
            best_i = torch.gather(cand_i, 1, sel)
        out_d[a : a + block] = best_d
        out_i[a : a + block] = best_i.to(torch.int32)
    return out_d, out_i


def pq_knn(
    X,
    k: int = 15,
    M: int = 16,
    generator: Optional[torch.Generator] = None,
    train_size: int = 65_536,
    refine_from=None,
    refine_factor: int = 4,
    train_rows=None,
    init_centers=None,
    device="auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN through PQ codes, on X's device (numpy: ``device``).

    The codebooks are trained on X itself up to ``train_size`` rows, else
    on ``train_size`` rows drawn from ``generator`` (or the given
    ``train_rows``); ``init_centers`` as in :func:`pq_train`. With
    ``refine_from`` (float32 rows in X's order) the ``refine_factor · k``
    best ADC candidates are re-ranked by their exact squared distances.
    """
    X = _as_rows(X, device)
    n = X.shape[0]
    if generator is None:
        generator = torch.Generator(device=X.device)
        generator.manual_seed(0)
    if train_rows is not None:
        train = X[torch.as_tensor(np.array(train_rows), device=X.device).long()]
    elif n <= train_size:
        train = X
    else:
        train = X[torch.randperm(n, generator=generator, device=generator.device)[:train_size]
                  .to(X.device)]
    cb = pq_train(train, M=M, generator=generator, init_centers=init_centers)
    codes = pq_encode(X, cb)
    rows = torch.arange(n, device=X.device)
    if refine_from is None:
        return pq_search(X, codes, cb, k=k, exclude_rows=rows)
    _, i_adc = pq_search(X, codes, cb, k=refine_factor * k, exclude_rows=rows)
    ref = _as_rows(refine_from, device).to(X.device)
    out_d = torch.empty((n, k), dtype=torch.float32, device=X.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=X.device)
    step = max(1, (1 << 26) // max(1, refine_factor * k * X.shape[1]))
    for a in range(0, n, step):
        cand = i_adc[a : a + step]
        diff = X[a : a + step, None, :] - ref[cand.long()]
        D, sel = torch.topk(torch.sum(diff * diff, dim=-1), k, dim=1, largest=False)
        out_d[a : a + step] = D
        out_i[a : a + step] = torch.gather(cand, 1, sel)
    return out_d, out_i
