"""The precisions the reference runs in.

``float64`` is the reference. ``control`` is the reference put in the
program's place one precision below what the configuration states (float32
with TF32 off): its matrix products in TF32, emulated as the tensor cores
compute it (each input rounded to TF32's 10 explicit mantissa bits, the
products summed in float32), and its elementwise arithmetic in bfloat16.
The emulation gives the same numbers on the CPU and on the card.
"""

from __future__ import annotations

import contextlib

import torch

REFERENCE = "float64"
CONTROL = "control"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits),
    ties away from zero, as the tensor cores read their inputs."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


@contextlib.contextmanager
def tf32_off():
    """Float32 products at full float32 inside, the caller's setting after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def check_mode(mode: str) -> None:
    if mode not in (REFERENCE, CONTROL):
        raise ValueError(f"unknown precision mode {mode!r}")
