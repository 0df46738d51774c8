"""knn_s (s): the kNN phase, ``timings_["knn"]`` (mean over the window's fits)."""

from perfbench.readers import mean_over_fits


def read(ctx):
    return mean_over_fits(ctx, lambda f: f["timings"]["knn"])
