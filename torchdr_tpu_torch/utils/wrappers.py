"""Input/output format handling (counterpart of ``torchdr_tpu/utils/wrappers.py``).

Accepts numpy arrays, torch tensors and anything ``np.asarray`` takes, and
restores the caller's container on output: a torch tensor comes back as a
tensor on the fit's device, everything else as a numpy array.

:func:`full_float32` holds cuBLAS at full float32 inside the public entry
points, where the JAX package passes ``precision=HIGHEST`` on each product.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch


# cuBLAS's TF32 switch is process-wide, so the nesting count is too: only
# the outermost entry point, in any thread, sets and restores it.
_FULL_FLOAT32_LOCK = threading.Lock()
_full_float32_depth = 0
_caller_precision: Tuple[Optional[str], Optional[str]] = (None, None)


def _set_full_float32() -> None:
    global _caller_precision
    matmul = torch.backends.cuda.matmul
    # torch >= 2.9 also keeps a per-backend setting; older torch has none
    fine = getattr(matmul, "fp32_precision", None)
    try:
        coarse = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller mixed torch's legacy and per-backend calls
        coarse = None
    _caller_precision = (coarse, fine)
    # sets the legacy and the per-backend state together, so they agree
    torch.set_float32_matmul_precision("highest")


def _restore_caller_precision() -> None:
    coarse, fine = _caller_precision
    if coarse is not None:
        torch.set_float32_matmul_precision(coarse)
    matmul = torch.backends.cuda.matmul
    if fine is not None and matmul.fp32_precision != fine:
        matmul.fp32_precision = fine


@contextlib.contextmanager
def full_float32():
    """Hold float32 matrix products at full float32 (no TF32), and give the
    caller back its own setting on exit, also on an exception.

    A TF32 distance gram keeps about three decimal digits and flips
    neighbour ranks; the JAX package passes ``precision=HIGHEST`` on each
    product, which no global setting changes. torch has no per-call switch,
    so every public entry point of the port (the estimators' ``fit``,
    ``fit_transform`` and ``transform``, ``Affinity.__call__``, the kNN, IVF,
    k-means and PQ functions, the ``eval`` functions) runs inside this
    context; it nests, and only the outermost entry sets and restores
    torch's state. Usable as a decorator: ``@full_float32()``.
    """
    global _full_float32_depth
    with _FULL_FLOAT32_LOCK:
        if _full_float32_depth == 0:
            _set_full_float32()
        _full_float32_depth += 1
    try:
        yield
    finally:
        with _FULL_FLOAT32_LOCK:
            _full_float32_depth -= 1
            if _full_float32_depth == 0:
                _restore_caller_precision()


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

    The host-side twin of :func:`to_torch`, for the pre-fit checks done
    before the single push to the device, and numpy's duplicate-row test.
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


def _hashable(Xn: np.ndarray) -> bool:
    """Whether the rows' bytes split into whole 32-bit words, the row hash's."""
    return (Xn.dtype.itemsize * Xn.shape[1]) % 4 == 0 and Xn.shape[1] > 0


def _exact_deduplicate(X, Xn: np.ndarray):
    """numpy's row sort: the exact path, taken where the row hashes cannot
    show all rows distinct. Counted in ``deduplicate.exact_calls``."""
    deduplicate.exact_calls += 1
    X_unique, inverse = np.unique(Xn, axis=0, return_inverse=True)
    if X_unique.shape[0] == Xn.shape[0]:
        return X, None
    return X_unique, inverse.reshape(-1)


def deduplicate(X: np.ndarray):
    """Host-side duplicate-row removal, in numpy.

    Returns (X_unique, inverse_indices or None). A row-hash prefilter
    decides duplicate-freeness first (equal rows have equal hashes), so the
    common case skips numpy's lexicographic row sort. The prefilter compares
    bytes (a row of -0.0 hashes unlike one of 0.0); the row sort, run only
    where two hashes collide, compares floats.

    A fit (``DRModule.fit_transform``) calls it on the CPU. On a CUDA
    device the fit hashes the rows on the card after their copy there
    (``ops/cuda/hash_kernel.deduplicate_fit_input``; its kernel's launches
    are counted in ``row_hash.launches``) and takes the same row sort only
    where two hashes collide, with the same result.
    ``deduplicate.exact_calls`` counts the row sorts of both.
    """
    Xn = np.asarray(X)
    if _hashable(Xn):
        h = _row_hashes(Xn)
        if np.unique(h).shape[0] == Xn.shape[0]:
            return X, None
    return _exact_deduplicate(X, Xn)


deduplicate.exact_calls = 0
