"""api_dedup_s (s): the host's duplicate-row test of the input (a hash of
each row, and numpy's row sort where hashes collide),
``timings_["api.dedup"]`` (mean over the window's fits)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("api.dedup",), lambda t, f: t["api.dedup"])
