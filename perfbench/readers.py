"""Arithmetic the metric readers in ``perfbench/metrics/`` share.

A reader's ``read(ctx)`` gets the run's context: ``setup_s``; ``fits``, one
record per timed fit (``wall_s``, the fit's ``timings`` as the estimator's
``timings_`` holds them, ``n_iter``, ``peak_bytes``); ``X`` and the last
fit's embedding ``Z``; ``seed``; ``device``; ``judged``, what the check of
the last fit found; ``profile``, the traced fit read by
:func:`perfbench.trace.profile_fit` with its ``shapes`` (None untraced);
and the ``cell``. It returns None where the run holds nothing to read.
"""

from __future__ import annotations

import re


def mean_over_fits(ctx, value):
    """The mean of ``value(fit)`` over the timed fits."""
    fits = ctx["fits"]
    return sum(value(f) for f in fits) / len(fits) if fits else None


def roofline_percent(ctx, kernel):
    """A kernel's least time over its mean device time a launch in the
    traced fit, in percent; None where the fit did not launch it. ``kernel``
    is its module in ``perfbench/roofline`` (``KERNELS``, ``COUNTER``,
    ``shape_bound_ms``)."""
    prof = ctx["profile"]
    if prof is None or not prof["launches"].get(kernel.__name__.rsplit(".", 1)[-1]):
        return None
    launches = prof["launches"][kernel.__name__.rsplit(".", 1)[-1]]
    pattern = re.compile(r"(?<!\w)(" + "|".join(kernel.KERNELS) + r")(?!\w)")
    device_s = sum(s for name, s in prof["device_s_by_name"].items() if pattern.search(name))
    if device_s <= 0:
        return None
    bound_ms, _ = kernel.shape_bound_ms(prof["shapes"])
    return 100.0 * bound_ms / (device_s * 1e3 / launches)
