"""Input/output format handling (counterpart of ``torchdr_tpu/utils/wrappers.py``).

Accepts numpy arrays, torch tensors and anything ``np.asarray`` takes, and
restores the caller's container on output: a torch tensor comes back as a
tensor on the fit's device, everything else as a numpy array.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch


def to_torch(
    X: Any, device: Optional[torch.device] = None, dtype=torch.float32
) -> Tuple[torch.Tensor, str]:
    """Convert input to a tensor; returns (tensor, original_format).

    A tensor stays on its device unless ``device`` is given.
    original_format is "torch", "numpy" or "other".
    """
    if isinstance(X, torch.Tensor):
        return X.to(device=device if device is not None else X.device, dtype=dtype), "torch"
    fmt = "numpy" if isinstance(X, np.ndarray) else "other"
    arr = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
    return torch.from_numpy(arr).to(device=device or "cpu", dtype=dtype), fmt


def to_host(X: Any, dtype=np.float32) -> Tuple[np.ndarray, str]:
    """Normalize input to a host numpy array; returns (array, format).

    The host-side twin of :func:`to_torch`, for pre-fit work (validation,
    deduplication) done before the single push to the device.
    """
    if isinstance(X, torch.Tensor):
        return np.asarray(X.detach().cpu().numpy(), dtype=dtype), "torch"
    if isinstance(X, np.ndarray):
        return np.asarray(X, dtype=dtype), "numpy"
    return np.asarray(X, dtype=dtype), "other"


def restore_format(Z: torch.Tensor, fmt: str):
    """Convert output back to the input container type."""
    if fmt == "torch":
        return Z
    return Z.detach().cpu().numpy()


def validate_2d(X: np.ndarray, name: str = "X") -> np.ndarray:
    if X.ndim != 2:
        raise ValueError(f"[TorchDR-Torch] ERROR : {name} must be 2D, got shape {X.shape}.")
    if X.shape[0] == 0:
        raise ValueError(f"[TorchDR-Torch] ERROR : {name} is empty.")
    if not np.all(np.isfinite(X)):
        raise ValueError(f"[TorchDR-Torch] ERROR : {name} contains NaN or Inf values.")
    return X


def _row_hashes(Xn: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a-style hash of each row's exact bytes."""
    view = np.ascontiguousarray(Xn).view(np.uint32)
    acc = np.full((Xn.shape[0],), np.uint64(0xCBF29CE484222325))
    prime = np.uint64(1099511628211)
    for j in range(view.shape[1]):
        acc = (acc ^ view[:, j].astype(np.uint64)) * prime
    return acc


def deduplicate(X: np.ndarray):
    """Host-side duplicate-row removal, in numpy.

    Returns (X_unique, inverse_indices or None). A row-hash prefilter
    decides duplicate-freeness first (equal rows have equal hashes), so the
    common case skips numpy's lexicographic row sort.
    """
    Xn = np.asarray(X)
    if (Xn.dtype.itemsize * Xn.shape[1]) % 4 == 0 and Xn.shape[1] > 0:
        h = _row_hashes(Xn)
        if np.unique(h).shape[0] == Xn.shape[0]:
            return X, None
    X_unique, inverse = np.unique(Xn, axis=0, return_inverse=True)
    if X_unique.shape[0] == Xn.shape[0]:
        return X, None
    return X_unique, inverse.reshape(-1)
