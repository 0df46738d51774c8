"""mesh_replicate_s (s): the IVF index and the shards' query rows copied from
the first card to the mesh's other cards, ``timings_["knn.replicate"]``
(mean over the window's fits; the mesh cell)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("knn.replicate",), lambda t, f: t["knn.replicate"])
