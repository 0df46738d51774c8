"""Learning-rate schedules (counterpart of ``torchdr_tpu/utils/schedulers.py``).

A schedule is a function ``factor(t_local, total) -> float`` of the step
counter, evaluated on the host each step (the counter is a Python int, so
it reads nothing from the device). Semantics mirror the torch schedulers.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

ScheduleFn = Callable[[float, float], float]


def make_scheduler(name: Optional[str], kwargs: Optional[Dict] = None) -> ScheduleFn:
    """Return factor(t_local, total_iters) for the named schedule.

    Supported: None (constant 1), "LinearLR", "ExponentialLR",
    "CosineAnnealingLR", "ConstantLR".
    """
    kwargs = dict(kwargs or {})

    if name is None:
        return lambda t, total: 1.0

    if name == "LinearLR":
        start = float(kwargs.get("start_factor", 1.0 / 3.0))
        end = float(kwargs.get("end_factor", 1.0))
        total_override = kwargs.get("total_iters", None)

        def linear(t, total):
            tt = float(total_override if total_override is not None else total)
            frac = min(max(t / max(tt, 1.0), 0.0), 1.0)
            return start + (end - start) * frac

        return linear

    if name == "ExponentialLR":
        gamma = float(kwargs.get("gamma", 0.99))
        return lambda t, total: gamma ** float(t)

    if name == "CosineAnnealingLR":
        eta_min_ratio = float(kwargs.get("eta_min_ratio", 0.0))
        t_max_override = kwargs.get("T_max", None)

        def cosine(t, total):
            tt = float(t_max_override if t_max_override is not None else total)
            frac = min(max(t / max(tt, 1.0), 0.0), 1.0)
            return eta_min_ratio + (1 - eta_min_ratio) * 0.5 * (1 + math.cos(math.pi * frac))

        return cosine

    if name == "ConstantLR":
        factor = float(kwargs.get("factor", 1.0 / 3.0))
        total_override = kwargs.get("total_iters", None)

        def const(t, total):
            tt = float(total_override if total_override is not None else total)
            return factor if t < tt else 1.0

        return const

    raise ValueError(f"[TorchDR-Torch] ERROR: Scheduler '{name}' not supported.")
