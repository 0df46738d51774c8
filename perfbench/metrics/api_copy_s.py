"""api_copy_s (s): the input's copy to the card, synchronised
(``timings_["api.h2d"]``), and the embedding's way back, the inverse
gather and the copy into the caller's format (``["api.d2h"]``), summed
(mean over the window's fits)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("api.h2d", "api.d2h"),
                         lambda t, f: t["api.h2d"] + t["api.d2h"])
