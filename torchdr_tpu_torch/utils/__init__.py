"""Utilities: logging, validation, input formats, optimizers, schedules,
checkpoints, profiling and plots (counterpart of ``torchdr_tpu/utils``).

The JAX package's names, with two replaced on purpose: ``to_jax`` by
``to_torch``, and ``compile_cache_dir``/``enable_compile_cache`` (XLA's
persistent cache) by the hashed libraries of ``ops/cuda/build.py``, the
port's only compilation, kept in ``build_dir()``: the package's ``_build/``
where it is writable, else ``~/.cache/torchdr_tpu_torch/build``. Importing
this module builds nothing and does not import matplotlib.
"""

from .logger import get_logger, log_phase
from .optim import lbfgs_minimize, make_optimizer, normalize_optimizer_kwargs
from .schedulers import make_scheduler
from .validation import (
    check_entropy,
    check_marginal,
    check_NaNs,
    check_neighbor_param,
    check_nonnegativity,
    check_shape,
    check_similarity_dense_sparse,
    check_symmetry,
    check_type,
)
from .wrappers import deduplicate, restore_format, to_torch, validate_2d

from .checkpoint import load_estimator, save_estimator
from .encoders import MLP, make_mlp_encoder
from .manifold import (
    mobius_add,
    poincare_expmap,
    poincare_expmap0,
    poincare_inner,
    poincare_logmap,
    poincare_logmap0,
    poincare_project,
    poincare_ptransp,
    poincare_sqdist,
)
from .native_loader import NpyBatchLoader, native_available
from .profiling import PhaseTimer, device_trace
from .visu import plot_poincare_disk
