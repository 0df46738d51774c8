"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, 700 W).

Copied from ``chip_smoke.py``, where the port's kernel table was measured
against them. A card set below 700 W (``nvidia-smi`` ``power.limit``, which
every result line carries) runs below them.
"""

H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3


def least_ms(ops: float, bytes_moved: float) -> tuple:
    """(ms, what bounds it): the larger of the operations over the float32
    rate and the bytes over the memory rate."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
