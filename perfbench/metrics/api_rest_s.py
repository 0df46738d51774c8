"""api_rest_s (s): the fit's own span, ``timings_["fit"]``, less the spans
directly under it (the "api." spans, affinity, init and optimize): the API
layer's work that no span of its own covers (mean over the window's fits)."""

from perfbench.spans import FIT_PHASES, api_children, mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("fit",) + FIT_PHASES,
                         lambda t, f: t["fit"] - api_children(t))
