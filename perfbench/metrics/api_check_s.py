"""api_check_s (s): the input's conversion to a host array and its checks
(2-D, non-empty, finite), ``timings_["api.check"]`` (mean over the window's
fits)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("api.check",), lambda t, f: t["api.check"])
