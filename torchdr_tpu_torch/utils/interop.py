"""Carry a fitted state from the JAX package into the port.

:func:`load_reference_state` takes the state the JAX estimator computed
before its optimization loop, as numpy arrays, and installs it in the
port's estimator, so both continue from identical state. The port never
imports JAX: the caller extracts the arrays (``np.asarray(...)``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..base import resolve_device

#: keys of ``arrays`` and the estimator attribute each one fills: a
#: t-SNE/SNE fit's pre-loop state, to which a UMAP fit's adds the optional
#: ones
_STATE = {
    "affinity_in": "affinity_in_",
    "NN_indices": "NN_indices_",
    "init_embedding": "init_embedding_",
}
_OPTIONAL_STATE = {
    "neg_exclusion": "neg_exclusion_",
    "neg_valid_counts": "neg_valid_counts_",
}


def load_reference_state(estimator, arrays: Mapping[str, object]) -> None:
    """Install a reference fit's pre-loop state in ``estimator``.

    ``arrays`` holds numpy arrays under "affinity_in" and "NN_indices"
    (after pruning, for UMAP; None where the fit has none: PACMAP's
    affinity, a dense affinity's indices) and "init_embedding". A
    negative-sampling state adds the arrays "neg_exclusion" and
    "neg_valid_counts", and a UMAP state the floats "a" and "b". The
    tensors land on the estimator's device; ``n_samples_in_`` and
    a root generator are set as a fit would set them.
    """
    device = resolve_device(estimator.device)
    estimator.device_ = device
    for key, attr in {**_STATE, **_OPTIONAL_STATE}.items():
        if key not in arrays and key in _OPTIONAL_STATE:
            continue
        if arrays[key] is None:  # PACMAP's affinity, a dense affinity's indices
            setattr(estimator, attr, None)
            continue
        arr = np.asarray(arrays[key])
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        else:
            arr = arr.astype(np.int64)
        setattr(estimator, attr, torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    for key in ("a", "b"):
        if key in arrays:
            setattr(estimator, f"_{key}", float(arrays[key]))
    estimator.n_samples_in_ = int(np.asarray(arrays["init_embedding"]).shape[0])
    estimator._generator_ = estimator._root_generator()
