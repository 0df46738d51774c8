"""step_issue_ms (ms): the optimizer loop's time a step that it does not
spend waiting on the card, ``(timings_["optimize.loop"] -
timings_["optimize.wait"])`` over the steps (mean over the window's fits):
the host's issue of the steps' operations. A launch that blocks because the
card's launch queue is full counts here too, not as a wait."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("optimize.loop", "optimize.wait"), lambda t, f: (
        t["optimize.loop"] - t["optimize.wait"]) / f["n_iter"] * 1e3)
