"""Validation helpers (counterpart of ``torchdr_tpu/utils/validation.py``).

Each check takes torch tensors or numpy arrays and raises the exception the
JAX package's check raises on the same values.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    """``x`` as a numpy array (a tensor is detached and copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_neighbor_param(param, n: int, logger=None):
    """Clamp a neighbor-count-like parameter to [1, n-1]."""
    max_allowed = n - 1
    if param > max_allowed:
        if logger is not None:
            logger.warning(
                f"Neighbor parameter {param} exceeds n_samples-1={max_allowed}; clamping."
            )
        return max_allowed
    if param < 1:
        raise ValueError(
            f"[TorchDR-Torch] ERROR : neighbor parameter must be >= 1, got {param}."
        )
    return param


def check_NaNs(x, msg: str = "NaNs detected."):
    if bool(np.any(np.isnan(_numpy(x)))):
        raise ValueError(f"[TorchDR-Torch] {msg}")


def check_nonnegativity(x, tol: float = 1e-8):
    if bool(np.min(_numpy(x)) < -tol):
        raise ValueError("[TorchDR-Torch] ERROR : affinity matrix has negative entries.")


def check_shape(x, shape):
    got = tuple(np.shape(x))
    if got != tuple(shape):
        raise ValueError(f"[TorchDR-Torch] ERROR : expected shape {shape}, got {got}.")


def check_symmetry(P, tol: float = 1e-5):
    P = _numpy(P)
    if not np.allclose(P, P.T, atol=tol):
        raise ValueError("[TorchDR-Torch] ERROR : matrix is not symmetric.")


def check_marginal(P, marg, dim: int = 1, tol: float = 1e-5, log: bool = False):
    """Check that the row (or column) marginals equal ``marg``."""
    P = _numpy(P)
    marg = _numpy(marg)
    got = torch.logsumexp(torch.as_tensor(P), dim).numpy() if log else P.sum(axis=dim)
    if not np.allclose(got, marg, atol=tol):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : marginal mismatch (max err "
            f"{np.abs(got - marg).max():.2e})."
        )


def check_entropy(log_P, target_entropy, dim: int = 1, tol: float = 1e-3):
    """Check row entropies h(p) = -sum p (log p - 1) equal the target."""
    log_P = _numpy(log_P)
    target = _numpy(target_entropy)
    H = -np.sum(np.exp(log_P) * (log_P - 1.0), axis=dim)
    if not np.allclose(H, target, atol=tol):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : entropy mismatch (max err "
            f"{np.abs(H - target).max():.2e})."
        )


def check_type(x, expected_type):
    if not isinstance(x, expected_type):
        raise TypeError(f"[TorchDR-Torch] ERROR : expected {expected_type}, got {type(x)}.")


def check_similarity_dense_sparse(dense, sparse_values, sparse_indices, tol: float = 1e-5):
    """Compare the kept entries of a padded sparse affinity (index -1 for a
    padding slot) with the same entries of a dense one."""
    dense = _numpy(dense)
    vals = _numpy(sparse_values)
    idx = _numpy(sparse_indices)
    rows = np.arange(dense.shape[0])[:, None]
    valid = idx >= 0
    picked = dense[rows, np.maximum(idx, 0)]
    err = np.abs(np.where(valid, picked - vals, 0.0)).max()
    if err > tol:
        raise ValueError(f"[TorchDR-Torch] ERROR : dense/sparse mismatch {err:.2e}.")
