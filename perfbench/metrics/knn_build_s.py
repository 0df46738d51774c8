"""knn_build_s (s): the IVF index's build inside the kNN phase (k-means, the
assignment, the host's balancing, the sorted layout),
``timings_["knn.build"]`` (mean over the window's fits; IVF cells)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("knn.build",), lambda t, f: t["knn.build"])
