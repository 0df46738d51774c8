"""k3_roofline (%): K3's least time on an H100 (``perfbench/roofline/k3.py``)
at the traced fit's shapes over its mean device time a launch there (its
kernels' device time over the launches ``rowlse_bwd.launches`` counted)."""

from perfbench.readers import roofline_percent
from perfbench.roofline import k3

COUNTERS = {"k3": k3.COUNTER}


def read(ctx):
    return roofline_percent(ctx, k3)
