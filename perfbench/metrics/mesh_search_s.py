"""mesh_search_s (s): the IVF search sharded over the mesh, from the issue of
every shard's search through to the graph gathered on the first card,
``timings_["knn.shards"]`` (mean over the window's fits; the mesh cell)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("knn.shards",), lambda t, f: t["knn.shards"])
