"""What the readers of the program's spans share (``perfbench/metrics/``).

A fit's ``timings`` are the estimator's ``timings_``: the wall seconds of
the program's spans (``torchdr_tpu_torch/utils/profiling.py``), each
synchronised on the card at its end, under dotted names (``"knn.build"``
is a part of ``"knn"``). A program that does not record a span (an older
one, or a fit on another path) leaves the metrics that read it out of the
result line: their readers return None.
"""

from __future__ import annotations

from perfbench.readers import mean_over_fits

#: the spans directly under "fit" besides the "api." ones
FIT_PHASES = ("affinity", "init", "optimize")


def mean_of_spans(ctx, keys, value):
    """The mean over the timed fits of ``value(timings, fit)``, or None
    where a fit lacks one of ``keys``."""
    fits = ctx["fits"]
    if not fits or any(k not in f["timings"] for f in fits for k in keys):
        return None
    return mean_over_fits(ctx, lambda f: value(f["timings"], f))


def api_children(timings) -> float:
    """The seconds of the spans directly under "fit": the "api." spans and
    the phases."""
    return sum(v for k, v in timings.items() if k.startswith("api.")) + sum(
        timings[p] for p in FIT_PHASES)
