"""knn_search_s (s): the IVF search inside the kNN phase, every row a query
against the index just built, ``timings_["knn.search"]`` (mean over the
window's fits; IVF cells)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("knn.search",), lambda t, f: t["knn.search"])
