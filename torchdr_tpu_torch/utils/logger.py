"""Per-class logging utilities (counterpart of ``torchdr_tpu/utils/logger.py``).

``log_phase`` also records each phase's wall time into a caller's dict, so
an estimator can report where a fit spent its time. Work on the card is
asynchronous: a phase timed on a CUDA device synchronises that device once,
at the end of the phase, so the time covers the work it enqueued. A phase
is a span of ``utils/profiling.py``: inside a fit, the spans opened under
it are recorded as ``<phase>.<name>``.
"""

from __future__ import annotations

import contextlib
import logging
import sys
from typing import Dict, Optional

import torch

from .profiling import phase_span

_PREFIX = "[TorchDR-Torch]"


def get_logger(name: str, verbose: bool = False) -> logging.Logger:
    """Return a logger named after the owning class.

    INFO level iff ``verbose``, WARNING otherwise.
    """
    logger = logging.getLogger(f"torchdr_tpu_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(f"{_PREFIX} {name}: %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(logging.INFO if verbose else logging.WARNING)
    return logger


@contextlib.contextmanager
def log_phase(
    logger: logging.Logger,
    phase: str,
    record: Optional[Dict[str, float]] = None,
    device: Optional[torch.device] = None,
):
    """Log (and optionally record in ``record[phase]``) a phase's wall time."""
    logger.info(f"----- {phase} -----")
    timed = phase_span(phase, record, device)
    try:
        with timed:
            yield
    finally:
        logger.info(f"{phase} took {timed.seconds:.3f}s")
