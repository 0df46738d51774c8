"""Estimator checkpointing (counterpart of ``torchdr_tpu/utils/checkpoint.py``).

The files are the JAX package's: fitted array attributes go into
``<path>.npz`` and the constructor's JSON-serializable params into
``<path>.json`` (``class``, ``module``, ``params``), so the fitted arrays of
a checkpoint load into either package.

The encoder differs. The JAX package writes its flax variables to
``<path>.flax`` (msgpack); the port writes its encoder's named tensors,
keyed by the ``torch.nn.Module``'s parameter names, to
``<path>.encoder.npz``. A ``.flax`` file is not read here:
``utils/interop.load_encoder_variables`` carries flax variables across.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

_SKIP_TYPES = (str, bool)
ENCODER_SUFFIX = ".encoder.npz"


def _arrayable(v):
    return hasattr(v, "shape") or isinstance(v, (int, float, np.number))


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_estimator(model, path: str) -> None:
    """Save a fitted estimator to ``<path>.npz`` (+ ``<path>.json``, and
    ``<path>.encoder.npz`` for a parametric fit)."""
    path = Path(path)
    arrays = {}
    for name, value in vars(model).items():
        if not name.endswith("_") or name.startswith("_"):
            continue
        if name == "encoder_variables_":
            continue
        if _arrayable(value) and not isinstance(value, _SKIP_TYPES):
            arrays[name] = _host(value)
    np.savez(str(path.with_suffix(".npz")), **arrays)

    meta = {
        "class": type(model).__name__,
        "module": type(model).__module__,
        "params": {},
    }
    for key, value in model.get_params().items():
        try:
            json.dumps(value)
            meta["params"][key] = value
        except TypeError:
            meta["params"][key] = None  # non-serializable (affinity objects...)
    path.with_suffix(".json").write_text(json.dumps(meta, indent=2))

    if getattr(model, "encoder", None) is not None and hasattr(
        model, "encoder_variables_"
    ):
        np.savez(str(path.with_suffix(ENCODER_SUFFIX)),
                 **{k: _host(v) for k, v in model.encoder_variables_.items()})


def _load_encoder(model, path: Path, n_features: int, device: torch.device) -> dict:
    """The encoder's weights of ``<path>.encoder.npz`` on ``device``, their
    names and shapes checked against ``model.encoder``."""
    encoder = model.encoder
    if hasattr(encoder, "build"):  # an MLP makes its layers for its input width
        encoder.build(n_features)
    expected = {k: tuple(p.shape) for k, p in encoder.named_parameters()}
    data = np.load(str(path.with_suffix(ENCODER_SUFFIX)), allow_pickle=False)
    found = {k: tuple(data[k].shape) for k in data.files}
    if found != expected:
        raise ValueError(
            f"[TorchDR-Torch] ERROR : the checkpoint's encoder weights {found} are not "
            f"the encoder's {expected}."
        )
    return {k: torch.from_numpy(data[k]).to(device) for k in data.files}


def load_estimator(model, path: str):
    """Restore fitted state into an estimator instance of the same class.

    ``model`` must be constructed with the same hyperparameters (and the
    same encoder module in parametric mode); only the fitted arrays are
    loaded, as tensors on the estimator's device (``device="auto"``: the
    card, raising without one). A 0-d array becomes a Python scalar. Sets
    ``device_`` and ``is_fitted_``, and ``_input_format_`` to "numpy" when
    the estimator has none.
    """
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    if meta["class"] != type(model).__name__:
        raise ValueError(
            f"[TorchDR-Torch] checkpoint is for {meta['class']}, got {type(model).__name__}."
        )
    encoder = getattr(model, "encoder", None) is not None
    if encoder and not path.with_suffix(ENCODER_SUFFIX).exists() and path.with_suffix(
        ".flax"
    ).exists():
        raise ValueError(
            f"[TorchDR-Torch] ERROR : {path.with_suffix('.flax')} holds flax encoder "
            "variables, which the port does not read; load them with "
            "utils/interop.load_encoder_variables (torchdr_tpu_torch.utils.interop) "
            "and save the estimator from the port."
        )
    # the fit's device: the card for "auto" (or raise), a mesh's first device
    device = model._resolve_device()
    data = np.load(str(path.with_suffix(".npz")), allow_pickle=False)
    for name in data.files:
        arr = data[name]
        setattr(model, name, torch.from_numpy(arr).to(device) if arr.ndim else arr.item())
    if encoder and path.with_suffix(ENCODER_SUFFIX).exists():
        model.encoder_variables_ = _load_encoder(
            model, path, int(data["n_features_in_"]), device
        )
    model.is_fitted_ = True
    if not hasattr(model, "_input_format_"):
        model._input_format_ = "numpy"
    return model
