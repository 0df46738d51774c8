"""k2_roofline (%): K2's least time on an H100 (``perfbench/roofline/k2.py``)
at the traced fit's shapes over its mean device time a launch there (its
kernels' device time over the launches ``rowlse_fwd.launches`` counted)."""

from perfbench.readers import roofline_percent
from perfbench.roofline import k2

COUNTERS = {"k2": k2.COUNTER}


def read(ctx):
    return roofline_percent(ctx, k2)
