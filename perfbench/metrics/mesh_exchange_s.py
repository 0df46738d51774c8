"""mesh_exchange_s (s): the fuzzy union's edge exchange over the mesh, the
shards' buckets through to the merged rows on the first card,
``timings_["affinity.exchange"]`` (mean over the window's fits; the mesh
cell)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("affinity.exchange",), lambda t, f: t["affinity.exchange"])
