"""Profiling hooks (counterpart of ``torchdr_tpu/utils/profiling.py``).

:func:`device_trace` is a context manager around ``torch.profiler`` that
writes a Chrome/Perfetto trace into a directory, as the JAX package's does
around ``jax.profiler``; :class:`PhaseTimer` accumulates host wall-clock
timings by name, beside the per-phase timings the verbose logger already
records (``utils/logger.log_phase``).

``device_trace`` takes a ``device`` the JAX package's has not: "auto"
records host operations and CUDA activity (kernels, copies) and raises
without a card; "cpu" records host operations only.

The spans of a fit. ``DRModule.fit_transform`` makes its estimator's
``timings_`` the active record for the fit's duration (:func:`fit_span`,
which also times the whole fit as ``"fit"``); code under the fit opens a
child span by name (:func:`span`) and needs no parameter for it. A span
records its wall seconds into the active record under a dotted name, its
parent's name and its own (``"knn.build"``); a span given a CUDA device
synchronises it at the end, so the time covers the work the span enqueued,
and a span given a device mesh (``parallel.Mesh``) synchronises each
distinct CUDA device of the mesh.
``log_phase``'s phases are spans too, recorded under their own names in
the record their caller passes, and they name their children. With no fit
active, :func:`span` records nothing and costs one context-variable read.
:func:`span_total` adds up the blocks of one name within its parent (the
optimizer loop's waits on the device).

Inside :func:`device_trace`, and only there, each span also opens a
``torch.profiler.record_function`` range named ``torchdr/<name>``, so the
trace shows the program's phases on the kernels' clock. Under any other
profiler the spans emit no event: on a CUDA trace such a range also yields
a device-typed annotation, which a reading of device busy time would count.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, Optional

import torch

#: the active fit's (record, prefix of the open span's children), or None
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("torchdr_tpu_torch_span", default=None)
#: True inside device_trace alone: spans then open profiler ranges
_annotate = False
_OFF = contextlib.nullcontext()


def _cuda_devices(device, mesh) -> tuple:
    """The distinct CUDA devices among ``device`` and the mesh's, in order."""
    devices = ([] if device is None else [torch.device(device)]) + (
        [] if mesh is None else list(mesh.devices))
    return tuple(dict.fromkeys(d for d in devices if d.type == "cuda"))


class _Span:
    """Times a block: its wall seconds into ``record[key]`` (added to what
    is there with ``add``), after synchronising ``device`` if it is a CUDA
    device, and each distinct CUDA device of ``mesh``. ``children`` is what
    the active record is inside the block (None leaves it). Reusable, one
    block at a time."""

    __slots__ = ("record", "key", "devices", "children", "add", "seconds", "_t0", "_token",
                 "_range")

    def __init__(self, record, key: str, device: Optional[torch.device] = None,
                 children=None, add: bool = False, mesh=None):
        self.record, self.key = record, key
        self.devices = _cuda_devices(device, mesh)
        self.children, self.add = children, add
        self.seconds = 0.0

    def __enter__(self):
        self._token = None if self.children is None else _ACTIVE.set(self.children)
        self._t0 = time.perf_counter()
        self._range = None
        if _annotate:
            self._range = torch.profiler.record_function("torchdr/" + self.key)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            for device in self.devices:
                torch.cuda.synchronize(device)
        finally:
            if self._range is not None:
                self._range.__exit__(*exc)
            self.seconds = time.perf_counter() - self._t0
            if self.record is not None:
                self.record[self.key] = self.seconds + (
                    self.record.get(self.key, 0.0) if self.add else 0.0)
            if self._token is not None:
                _ACTIVE.reset(self._token)
        return False


def fit_span(record: Dict[str, float], device: Optional[torch.device] = None) -> _Span:
    """The root span of a fit: ``record`` is the active record inside the
    block, whose seconds go into ``record["fit"]``; its children's names
    carry no prefix. A fit inside the block has its own record, and the
    outer one is active again when it ends, also after an exception."""
    return _Span(record, "fit", device, children=(record, ""))


def span(name: str, device: Optional[torch.device] = None, mesh=None):
    """A child of the open span, recorded in the active fit's record as
    ``<parent>.<name>`` (``name`` alone under the root); does nothing
    outside a fit. At its end it synchronises ``device`` and, on a mesh,
    every distinct device of ``mesh``."""
    active = _ACTIVE.get()
    if active is None:
        return _OFF
    record, prefix = active
    key = prefix + name
    return _Span(record, key, device, children=(record, key + "."), mesh=mesh)


def phase_span(phase: str, record: Optional[Dict[str, float]],
               device: Optional[torch.device] = None) -> _Span:
    """``log_phase``'s span: ``record[phase]`` (None records nothing), and
    inside a fit the parent of spans named ``<phase>.<child>``."""
    active = _ACTIVE.get()
    children = None if active is None else (active[0], phase + ".")
    return _Span(record, phase, device, children=children)


def span_total(name: str):
    """A reusable block whose seconds add up in the active record under
    ``<parent>.<name>`` (0.0 until the first block ends); does nothing
    outside a fit. It synchronises nothing itself: it times blocks that
    wait on the device."""
    active = _ACTIVE.get()
    if active is None:
        return _OFF
    record, prefix = active
    record.setdefault(prefix + name, 0.0)
    return _Span(record, prefix + name, add=True)


@contextlib.contextmanager
def device_trace(logdir: str = "/tmp/torchdr_tpu_torch_trace", device: str = "auto"):
    """Capture a ``torch.profiler`` trace viewable in Perfetto or TensorBoard.

    The trace is written into ``logdir`` as ``<worker>.<ms>.pt.trace.json``
    when the block ends; the block receives ``logdir``. Besides the host
    operations (and with "auto" the kernels and copies), it carries the
    spans of every fit run inside the block, each as a range named
    ``torchdr/<span>`` whose length is the span's ``timings_`` entry: the
    fit (``torchdr/fit``), its phases and their parts.
    """
    global _annotate
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
        annotate, _annotate = _annotate, True
        try:
            yield logdir
        finally:
            _annotate = annotate
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
