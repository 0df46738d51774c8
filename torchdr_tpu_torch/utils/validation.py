"""Validation helpers (counterpart of ``torchdr_tpu/utils/validation.py``)."""

from __future__ import annotations


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
