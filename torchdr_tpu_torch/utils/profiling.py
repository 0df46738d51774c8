"""Profiling hooks (counterpart of ``torchdr_tpu/utils/profiling.py``).

:func:`device_trace` is a context manager around ``torch.profiler`` that
writes a Chrome/Perfetto trace into a directory, as the JAX package's does
around ``jax.profiler``; :class:`PhaseTimer` accumulates host wall-clock
timings by name, beside the per-phase timings the verbose logger already
records (``utils/logger.log_phase``).

``device_trace`` takes a ``device`` the JAX package's has not: "auto"
records host operations and CUDA activity (kernels, copies) and raises
without a card; "cpu" records host operations only.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


@contextlib.contextmanager
def device_trace(logdir: str = "/tmp/torchdr_tpu_torch_trace", device: str = "auto"):
    """Capture a ``torch.profiler`` trace viewable in Perfetto or TensorBoard.

    The trace is written into ``logdir`` as ``<worker>.<ms>.pt.trace.json``
    when the block ends; the block receives ``logdir``.
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "[TorchDR-Torch] ERROR : device_trace(device='auto') traces the CUDA device "
                "and none is available; pass device='cpu' to trace host operations only."
            )
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    elif device == "cpu":
        activities = [ProfilerActivity.CPU]
    else:
        raise ValueError(
            f"[TorchDR-Torch] ERROR : device_trace takes device 'auto' or 'cpu', got {device!r}."
        )
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield logdir
        finally:
            if len(activities) > 1:
                torch.cuda.synchronize()  # the block's kernels end inside the trace


class PhaseTimer:
    """Accumulate named phase wall-clock timings (host-side)."""

    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def summary(self) -> str:
        total = sum(self.timings.values())
        lines = [f"{k}: {v:.3f}s ({100 * v / total:.0f}%)" for k, v in self.timings.items()]
        return " | ".join(lines)
