"""The row hash of a fit's duplicate-row test, on the card.

Replaces no TPU kernel: the JAX package tests on the host whether a fit's
rows are all distinct (``utils/wrappers._row_hashes``, then numpy's row
sort where hashes collide). The port copies the rows to the card first and
hashes them there. The CUDA source is ``ops/csrc/row_hash.cu``; its note
gives the bound on the card (one read of the rows) and what the design
does about it (a block's rows staged a chunk of columns at a time by
``cp.async`` into two buffers, one row's hash a thread, carried across the
chunks).

:func:`row_hash` launches the kernel on a CUDA tensor and counts its
launches in ``row_hash.launches``. :func:`deduplicate_fit_input` is the
fit's duplicate-row test: on the card through :func:`row_hash`, elsewhere
``utils/wrappers.deduplicate`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.wrappers import _exact_deduplicate, _hashable, deduplicate
from .build import launch, load_function


def row_hash(X: torch.Tensor) -> torch.Tensor:
    """FNV-1a over each row's 32-bit words, in column order.

    Parameters
    ----------
    X : (n, m) float32 CUDA tensor.

    Returns the (n,) int64 tensor on X's device whose bits are the uint64
    hashes of ``utils/wrappers._row_hashes`` (``.numpy().view(np.uint64)``
    gives them back): equal rows, byte for byte, have equal hashes.
    """
    if X.ndim != 2 or X.dtype != torch.float32:
        raise ValueError(f"X must be a 2D float32 tensor, got {X.dtype} {tuple(X.shape)}.")
    if X.device.type != "cuda":
        raise ValueError(f"row_hash: X must be on a CUDA device, got {X.device}.")
    n, m = X.shape
    if not X.is_contiguous() or X.data_ptr() % 16:
        X = X.clone(memory_format=torch.contiguous_format)  # a fresh allocation is aligned
    out = torch.empty(n, dtype=torch.int64, device=X.device)
    if n == 0:
        return out
    rc = launch(load_function("row_hash"), X, X.data_ptr(), out.data_ptr(), n, m)
    if rc != 0:
        raise RuntimeError(f"row_hash launch failed: cudaError {rc}.")
    row_hash.launches += 1
    return out


row_hash.launches = 0


def deduplicate_fit_input(X_host: np.ndarray, X_dev: torch.Tensor):
    """A fit's duplicate-row removal, after the copy of its rows ``X_host``
    to its device (``X_dev``).

    Returns (rows on the device, inverse or None), the rows ``X_dev`` itself
    where nothing repeats, else ``X_unique`` copied to the device: each the
    result of ``deduplicate(X_host)``, bit for bit. On a CUDA device the
    rows' hashes are computed and sorted on the card and one scalar is read
    back; numpy's row sort of ``X_host`` runs only where two hashes are
    equal. On any other device ``deduplicate`` runs on the host, as it is.
    """
    if X_dev.device.type == "cuda" and _hashable(X_host):
        h = torch.sort(row_hash(X_dev)).values
        if not bool((h[1:] == h[:-1]).any()):
            return X_dev, None
        X_unique, inverse = _exact_deduplicate(X_host, X_host)
    else:
        X_unique, inverse = deduplicate(X_host)
    if inverse is None:
        return X_dev, None
    return torch.from_numpy(np.ascontiguousarray(X_unique)).to(X_dev.device), inverse
