"""Base estimator for all dimensionality-reduction modules.

Counterpart of ``torchdr_tpu/base.py``. Fitted state is plain tensors on
attributes with trailing underscores, sklearn style. Differences:

- ``device="auto"`` resolves to ``cuda`` and raises when no card is
  present; only an explicit ``device="cpu"`` runs on the CPU. There is no
  silent fallback.
- Seeding is a root ``torch.Generator`` on the fit's device, seeded from
  ``random_state``, in place of the JAX package's root PRNG key.
"""

from __future__ import annotations

import inspect
from abc import ABC, abstractmethod
from typing import Any, Optional

import numpy as np
import torch

from .utils.logger import get_logger
from .utils.wrappers import deduplicate, full_float32, restore_format, to_host, validate_2d


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    return (a.index if a.index is not None else torch.cuda.current_device()) == (
        b.index if b.index is not None else torch.cuda.current_device()
    )


def resolve_device(device, mesh=None) -> torch.device:
    """``"auto"``/None -> ``cuda`` (raises without a card); else as given.

    With a device mesh, "auto" is the mesh's first device, where a fit keeps
    its state; any other device must be that one."""
    if mesh is not None:
        first = mesh.devices[0]
        if device is None or device == "auto":
            return first
        if not _same_device(torch.device(device), first):
            raise ValueError(
                f"[TorchDR-Torch] ERROR : device={device!r} and the mesh's first device "
                f"{first} differ; a fit keeps its state on the mesh's first device."
            )
        return first
    if device is None or device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "[TorchDR-Torch] ERROR : device='auto' needs a CUDA device and "
                "none is available; pass device='cpu' to run on the CPU."
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class BaseEstimator:
    """Minimal sklearn-compatible parameter handling (get/set_params, repr)."""

    @classmethod
    def _get_param_names(cls):
        sig = inspect.signature(cls.__init__)
        return sorted(
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
        )

    def get_params(self, deep: bool = True):
        return {name: getattr(self, name, None) for name in self._get_param_names()}

    def set_params(self, **params):
        valid = set(self._get_param_names())
        for key, value in params.items():
            if key not in valid:
                raise ValueError(
                    f"Invalid parameter {key!r} for estimator {type(self).__name__}."
                )
            setattr(self, key, value)
        return self

    def __repr__(self):
        params = ", ".join(f"{k}={v!r}" for k, v in sorted(self.get_params().items()))
        return f"{type(self).__name__}({params})"


class DRModule(BaseEstimator, ABC):
    """Base class for dimensionality reduction methods.

    Subclasses implement :meth:`_fit_transform` on a tensor that already
    lies on ``self.device_``.

    Parameters
    ----------
    n_components : int, default=2
    device : str, default="auto"
        "auto" = the current CUDA device (raises without one); "cpu" or any
        torch device string is taken as given.
    verbose : bool, default=False
    random_state : int, optional
        Seed of the root ``torch.Generator``.
    process_duplicates : bool, default=True
        Deduplicate identical rows on the host before fitting and map the
        embedding back.
    """

    def __init__(
        self,
        n_components: int = 2,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        process_duplicates: bool = True,
        **kwargs,
    ):
        self.n_components = n_components
        self.device = device if device is not None else "auto"
        self.verbose = verbose
        self.random_state = random_state
        self.process_duplicates = process_duplicates
        self.logger = get_logger(type(self).__name__, verbose)
        self.embedding_ = None
        self.is_fitted_ = False
        for key in kwargs:
            self.logger.warning(f"Ignoring unknown keyword argument {key!r}.")

    # --- device and generator ---

    def _resolve_mesh(self):
        """The device mesh of a fit, if any; with one, ``device="auto"``
        is its first device."""
        return getattr(self, "mesh", None)

    def _resolve_device(self) -> torch.device:
        self.device_ = resolve_device(self.device, self._resolve_mesh())
        return self.device_

    def _root_generator(self) -> torch.Generator:
        seed = (
            self.random_state
            if self.random_state is not None
            else np.random.randint(0, 2**31 - 1)
        )
        gen = torch.Generator(device=self.device_)
        gen.manual_seed(int(seed))
        return gen

    # --- Public API ---

    @full_float32()
    def fit(self, X, y: Optional[Any] = None) -> "DRModule":
        self.fit_transform(X, y=y)
        return self

    @full_float32()
    def fit_transform(self, X, y: Optional[Any] = None):
        """Fit the model and return the embedding.

        Validation and deduplication run on the host array, before the
        single push to the device; duplicate rows are mapped back through
        the inverse index.
        """
        device = self._resolve_device()
        X_host, fmt = to_host(X)
        validate_2d(X_host)
        self._input_format_ = fmt

        inverse = None
        if self.process_duplicates:
            X_host, inverse = deduplicate(X_host)
            if inverse is not None:
                self.logger.info(
                    f"Detected {inverse.shape[0] - X_host.shape[0]} duplicate "
                    "samples, performing DR on unique data."
                )
        X_dev = torch.from_numpy(np.ascontiguousarray(X_host)).to(device)
        emb = self._fit_transform(X_dev, y=y)
        if inverse is not None:
            emb = emb[torch.from_numpy(inverse).to(device)]
        self.embedding_ = emb
        self.is_fitted_ = True
        return restore_format(self.embedding_, fmt)

    @full_float32()
    def transform(self, X=None):
        """Return the training embedding."""
        if not self.is_fitted_:
            raise ValueError(
                "This DRModule instance is not fitted yet. "
                "Call 'fit' or 'fit_transform' with some data first."
            )
        if X is not None:
            raise NotImplementedError(
                "Transforming new data is not implemented for this model."
            )
        return restore_format(self.embedding_, getattr(self, "_input_format_", "numpy"))

    @abstractmethod
    def _fit_transform(self, X: torch.Tensor, y: Optional[Any] = None) -> torch.Tensor:
        raise NotImplementedError

    # Large intermediates dropped by clear_memory; subclasses extend.
    _memory_attrs = (
        "affinity_in_",
        "NN_indices_",
        "neg_exclusion_",
        "neg_valid_counts_",
        "_final_carry_",
    )

    def clear_memory(self):
        """Drop large fitted intermediates (affinities, sampling state)."""
        for name in self._memory_attrs:
            if hasattr(self, name):
                delattr(self, name)
