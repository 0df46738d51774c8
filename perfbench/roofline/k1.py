"""K1, the shared-negative UMAP repulsion (``ops/csrc/umap_repulsion.cu``).

``bound_ms`` is a frozen copy of ``chip_smoke.k1_bound_ms``: the larger of
K1's bytes over the memory rate (Z, w and the ids read once, the output
written once) and its float32 operations over the float32 rate, each of the
5d + 10 operations per pair (exp, log and divide as one each) counted once.
"""

from __future__ import annotations

from .peaks import least_ms

#: the kernel's device functions, as the profiler names them
KERNELS = ("repulsion_kernel",)
#: the wrapper whose ``.launches`` counts K1's calls
COUNTER = ("torchdr_tpu_torch.ops.cuda.umap_kernel", "fused_shared_repulsion")


def bound_ms(n: int, S: int, d: int) -> tuple:
    bytes_moved = 4 * n * d + 4 * n + 8 * S + 4 * n * d
    ops = n * S * (5 * d + 10)
    return least_ms(ops, bytes_moved)


def shape_bound_ms(shapes: dict) -> tuple:
    """The bound at a fit's shapes (``n``, ``S`` negatives, ``d``)."""
    return bound_ms(shapes["n"], shapes["S"], shapes["d"])
