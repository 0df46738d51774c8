"""K-means clustering (Lloyd's algorithm), k-means++ init.

Counterpart of ``torchdr_tpu/ops/kmeans.py``. Each Lloyd iteration is one
float32 distance product (in row blocks, so no (n, n_clusters) buffer
larger than ``_BLOCK_ELEMS`` is live), an ``index_add_`` segment sum and
one assignment pass, as in the JAX package.

The JAX loop stops as soon as the inertia moves by at most ``tol`` of
itself; testing that in torch reads a flag to the host, a device sync. The
loop therefore carries the stop condition on the device, freezes the state
once it fails (``torch.where``, so the result is bit-identical to stopping
there) and reads the flag only every ``sync_every`` iterations.

The random draws are torch's (``generator``); ``init_centers`` takes a
given draw instead, so a test can feed in the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .metrics import sq_dists_from_gram

_SYNC_EVERY = 8
# rows of one assignment block: at most this many (row, centre) distances live
_BLOCK_ELEMS = 1 << 25


def _assign(X: torch.Tensor, x_norm: torch.Tensor, centers: torch.Tensor):
    """Nearest centre of every row (int64) and the summed squared distance."""
    c_norm = torch.sum(centers * centers, dim=-1)
    rows = max(1, _BLOCK_ELEMS // max(1, centers.shape[0]))
    labels, mins = [], []
    for r0 in range(0, X.shape[0], rows):
        D = sq_dists_from_gram(x_norm[r0 : r0 + rows], c_norm, X[r0 : r0 + rows] @ centers.T)
        m, lab = torch.min(D, dim=1)
        labels.append(lab)
        mins.append(m)
    return torch.cat(labels), torch.sum(torch.cat(mins))


def _plus_plus_init(X: torch.Tensor, n_clusters: int, generator: torch.Generator):
    """k-means++ seeding: greedy D²-weighted sampling."""
    n = X.shape[0]
    first = int(torch.randint(0, n, (1,), generator=generator, device=X.device))
    centers = torch.zeros((n_clusters, X.shape[1]), dtype=X.dtype, device=X.device)
    centers[0] = X[first]
    d2 = torch.sum((X - X[first]) ** 2, dim=1)
    # fewer distinct rows than clusters leave every d2 at 0: then the JAX
    # package's draw (a search in the cumulative sum) takes row 0
    row0 = torch.zeros_like(d2)
    row0[0] = 1.0
    for i in range(1, n_clusters):
        total = torch.sum(d2)
        probs = torch.where(total > 0, d2 / torch.clamp(total, min=1e-12), row0)
        idx = torch.multinomial(probs, 1, generator=generator)
        centers[i] = X[idx[0]]
        d2 = torch.minimum(d2, torch.sum((X - X[idx]) ** 2, dim=1))
    return centers


def kmeans_fit(
    X: torch.Tensor,
    n_clusters: int,
    generator: Optional[torch.Generator] = None,
    max_iter: int = 100,
    tol: float = 1e-4,
    init: str = "++",
    init_centers: Optional[torch.Tensor] = None,
    sync_every: int = _SYNC_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run k-means; returns (centers, labels int32, inertia).

    ``init='++'`` is k-means++; ``init='random'`` seeds from rows at a
    fixed stride from a random offset (the coarse quantizer's convention,
    far cheaper when ``n_clusters`` is in the thousands). ``init_centers``
    skips the draw. ``generator`` defaults to one seeded with 0 on X's
    device.
    """
    n = X.shape[0]
    if n < n_clusters:
        raise ValueError(
            f"[TorchDR-Torch] ERROR : kmeans_fit needs n >= n_clusters "
            f"({n} < {n_clusters})."
        )
    if init not in ("++", "random"):
        raise ValueError(f"[TorchDR-Torch] ERROR : unknown kmeans init {init!r}.")
    X = X.to(torch.float32)
    x_norm = torch.sum(X * X, dim=-1)
    if init_centers is not None:
        centers = torch.as_tensor(init_centers, dtype=X.dtype, device=X.device).clone()
    else:
        if generator is None:
            generator = torch.Generator(device=X.device)
            generator.manual_seed(0)
        if init == "random":
            stride = max(1, n // n_clusters)
            start = int(torch.randint(0, stride, (1,), generator=generator, device=X.device))
            centers = X[start + stride * torch.arange(n_clusters, device=X.device)]
        else:
            centers = _plus_plus_init(X, n_clusters, generator)

    labels, inertia = _assign(X, x_norm, centers)
    prev = torch.full_like(inertia, float("inf"))
    active = torch.ones((), dtype=torch.bool, device=X.device)
    for it in range(max_iter):
        active = active & (torch.abs(prev - inertia) > tol * torch.abs(inertia))
        if it % sync_every == 0 and not bool(active):
            break
        counts = torch.zeros((n_clusters,), dtype=X.dtype, device=X.device)
        counts.index_add_(0, labels, torch.ones_like(x_norm))
        sums = torch.zeros_like(centers).index_add_(0, labels, X)
        new_centers = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers
        )
        new_labels, new_inertia = _assign(X, x_norm, new_centers)
        centers = torch.where(active, new_centers, centers)
        labels = torch.where(active, new_labels, labels)
        prev = torch.where(active, inertia, prev)
        inertia = torch.where(active, new_inertia, inertia)
    return centers, labels.to(torch.int32), inertia
