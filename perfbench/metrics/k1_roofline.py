"""k1_roofline (%): K1's least time on an H100 (``perfbench/roofline/k1.py``)
at the traced fit's shapes over its mean device time a launch there (its
kernels' device time over the launches ``fused_shared_repulsion.launches`` counted)."""

from perfbench.readers import roofline_percent
from perfbench.roofline import k1

COUNTERS = {"k1": k1.COUNTER}


def read(ctx):
    return roofline_percent(ctx, k1)
