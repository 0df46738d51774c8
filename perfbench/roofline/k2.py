"""K2, the row log-sum's forward (``ops/csrc/rowlse_fwd.cu``, square entry)."""

from __future__ import annotations

from .rowlse import bound_ms

#: its pair loop and its merge, as the profiler names them
KERNELS = ("rowlse_partial_kernel", "rowlse_merge_kernel")
COUNTER = ("torchdr_tpu_torch.ops.cuda.reduce_kernel", "rowlse_fwd")


def shape_bound_ms(shapes: dict) -> tuple:
    """The bound at a fit's shapes (``n``, ``d``, output ``kernel``)."""
    return bound_ms(shapes["n"], shapes["d"], "K2", shapes["kernel"])
