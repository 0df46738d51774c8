"""consts_s (s): what the optimizer loop builds once a fit before its first
step, the constants and the first carry (UMAP's edge schedule and periods),
``timings_["optimize.consts"]`` (mean over the window's fits)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("optimize.consts",), lambda t, f: t["optimize.consts"])
