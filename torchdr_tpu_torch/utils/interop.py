"""Carry a fitted state from the JAX package into the port.

:func:`load_reference_state` takes the state the JAX estimator computed
before its optimization loop, as numpy arrays, and installs it in the
port's estimator, so both continue from identical state;
:func:`load_incremental_pca_state` does the same for a fitted
``IncrementalPCA`` or ``ExactIncrementalPCA``, so that a port
``partial_fit`` or ``transform`` continues from the JAX package's fit;
:func:`load_encoder_variables` writes a flax MLP's weights into the port's
:class:`~torchdr_tpu_torch.utils.encoders.MLP`.
The port never imports JAX: the caller extracts the arrays
(``np.asarray(...)``).
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
    tensors land on the estimator's device (a mesh fit's: the mesh's first
    device); ``n_samples_in_``, the fit's mesh and a root generator are set
    as a fit would set them.
    """
    # a mesh fit keeps its state on the mesh's first device
    mesh = estimator._resolve_mesh()
    device = resolve_device(estimator.device, mesh)
    estimator.device_ = device
    estimator._fit_mesh_ = mesh
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


def load_incremental_pca_state(estimator, arrays: Mapping[str, object]) -> None:
    """Install a fitted incremental PCA state in ``estimator``.

    ``arrays`` holds "mean_", "components_", "explained_variance_" and
    "n_samples_seen_", and for ``IncrementalPCA`` also "var_" and
    "singular_values_". The host Welford state of ``IncrementalPCA``
    (``mean_``, ``var_``) stays a float64 numpy array; everything else
    becomes a float32 tensor on the estimator's device, as a fit leaves it.
    """
    device = resolve_device(estimator.device)
    estimator.device_ = device

    def dev(key):
        arr = np.ascontiguousarray(np.asarray(arrays[key], np.float32))
        return torch.from_numpy(arr).to(device)

    host = ("mean_", "var_") if "var_" in arrays else ()
    for key in ("mean_", "var_", "components_", "singular_values_", "explained_variance_"):
        if key not in arrays:
            continue
        value = np.asarray(arrays[key], np.float64) if key in host else dev(key)
        setattr(estimator, key, value)
    estimator.n_samples_seen_ = int(arrays["n_samples_seen_"])
    estimator.is_fitted_ = True


def load_encoder_variables(module, params: Mapping[str, object]):
    """Write a flax MLP's variables into ``module`` (an ``MLP``).

    ``params`` is ``{"params": {"Dense_i": {"kernel": (in, out), "bias":
    (out,)}}}`` as numpy arrays (the top "params" level may be left out).
    A kernel is transposed into ``Linear.weight``'s (out, in). The layers
    are made for the first kernel's input width. Returns the written
    variables by name, as a fit takes them for its starting weights.
    """
    dense = params.get("params", params)
    names = sorted(dense, key=lambda name: int(name.split("_")[-1]))
    kernels = [np.asarray(dense[name]["kernel"], np.float32) for name in names]
    if tuple(k.shape[1] for k in kernels) != tuple(module.features):
        raise ValueError(
            f"[TorchDR-Torch] ERROR : the flax layers' widths {[k.shape[1] for k in kernels]} "
            f"are not the MLP's {list(module.features)}."
        )
    module.build(kernels[0].shape[0])
    with torch.no_grad():
        for layer, name, kernel in zip(module.layers, names, kernels):
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.T)))
            layer.bias.copy_(torch.from_numpy(np.array(dense[name]["bias"], np.float32)))
    return {name: p.detach().clone() for name, p in module.named_parameters()}
