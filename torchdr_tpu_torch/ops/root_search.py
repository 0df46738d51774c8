"""Batched scalar root finding (counterpart of ``torchdr_tpu/ops/root_search.py``).

Each search is a Python loop over device tensors that converges all rows
at once with masked updates, in place of the JAX package's
``lax.while_loop``. The JAX loop stops as soon as no row is active; testing
that in torch reads a flag to the host, a device sync. Rows that are no
longer active are frozen by the mask (their state, and so the function
value, stays bit-identical), so extra iterations change nothing. The loops
therefore test the stop condition only every ``sync_every`` iterations:
the result is bit-identical to testing every iteration, with one sync per
``sync_every`` iterations.

The brackets live on the device of a tensor bound when one is given;
otherwise on ``device``, where "auto" (the default) means the CUDA card and
raises without one, as the estimators' ``device`` does.

All functions find roots of a batched *increasing* function ``f`` over
positive inputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..base import resolve_device

_DEFAULT_TOL = 1e-6
_SYNC_EVERY = 8

ArrayOrFloat = Union[float, torch.Tensor]


def _bounds_device(begin, end, device) -> torch.device:
    """A tensor bound's device, else ``device`` resolved ("auto" = the card)."""
    for v in (begin, end):
        if isinstance(v, torch.Tensor):
            return v.device
    return resolve_device(device)


def _as_vec(v: Optional[ArrayOrFloat], n: int, dtype, device) -> torch.Tensor:
    if v is None:
        v = 1.0
    v = torch.as_tensor(v, dtype=dtype, device=device)
    if v.ndim == 0:
        v = torch.full((n,), float(v), dtype=dtype, device=device)
    if v.shape != (n,):
        raise ValueError(f"bound must have shape ({n},), got {tuple(v.shape)}")
    return v


def init_bounds(
    f: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    begin: Optional[ArrayOrFloat] = 1.0,
    end: Optional[ArrayOrFloat] = 1.0,
    max_iter: int = 100,
    dtype=torch.float32,
    device="auto",
    sync_every: int = _SYNC_EVERY,
):
    """Expand brackets so that ``f(begin) <= 0 <= f(end)`` row-wise."""
    device = _bounds_device(begin, end, device)
    b = _as_vec(begin, n, dtype, device)
    e = _as_vec(end, n, dtype, device)

    # Shrink b downward until f(b) <= 0, pulling e in with it.
    for i in range(max_iter):
        mask = f(b) > 0
        if i % sync_every == 0 and not bool(mask.any()):
            break
        e = torch.where(mask, torch.minimum(e, b), e)
        b = torch.where(mask, b * 0.5, b)

    # Expand e upward until f(e) >= 0, pushing b out with it.
    for i in range(max_iter):
        mask = f(e) < 0
        if i % sync_every == 0 and not bool(mask.any()):
            break
        b = torch.where(mask, torch.maximum(b, e), b)
        e = torch.where(mask, e * 2.0, e)
    return b, e


def binary_search(
    f: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    begin: Optional[ArrayOrFloat] = 1.0,
    end: Optional[ArrayOrFloat] = 1.0,
    max_iter: int = 100,
    tol: float = _DEFAULT_TOL,
    dtype=torch.float32,
    device="auto",
    sync_every: int = _SYNC_EVERY,
) -> torch.Tensor:
    """Batched bisection."""
    b, e = init_bounds(
        f, n, begin, end, max_iter=max_iter, dtype=dtype, device=device,
        sync_every=sync_every,
    )
    f_b = f(b)
    m = (b + e) * 0.5
    f_m = f(m)
    for i in range(max_iter):
        active = torch.abs(f_m) >= tol
        if i % sync_every == 0 and not bool(active.any()):
            break
        same_sign = f_m * f_b > 0
        move_b = active & same_sign
        move_e = active & (~same_sign)
        b = torch.where(move_b, m, b)
        f_b = torch.where(move_b, f_m, f_b)
        e = torch.where(move_e, m, e)
        m = (b + e) * 0.5
        f_m = f(m)
    return m


def _secant(b, e, f_b, f_e):
    """The regula falsi point, its denominator kept at least 1e-30 away from 0."""
    denom = f_b - f_e
    tiny = torch.full_like(denom, 1e-30)
    denom = torch.where(torch.abs(denom) < 1e-30, torch.where(denom < 0, -tiny, tiny), denom)
    return b - (b - e) / denom * f_b


def false_position(
    f: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    begin: Optional[ArrayOrFloat] = 1.0,
    end: Optional[ArrayOrFloat] = 1.0,
    max_iter: int = 100,
    tol: float = _DEFAULT_TOL,
    dtype=torch.float32,
    device="auto",
    sync_every: int = _SYNC_EVERY,
) -> torch.Tensor:
    """Batched regula falsi. An inactive row's bracket is frozen, so its
    secant point is recomputed bit for bit: the stop test every
    ``sync_every`` iterations gives the every-iteration result."""
    b, e = init_bounds(
        f, n, begin, end, max_iter=max_iter, dtype=dtype, device=device,
        sync_every=sync_every,
    )
    f_b = f(b)
    f_e = f(e)
    m = _secant(b, e, f_b, f_e)
    f_m = f(m)
    for i in range(max_iter):
        active = torch.abs(f_m) >= tol
        if i % sync_every == 0 and not bool(active.any()):
            break
        same_sign = f_m * f_b > 0
        move_b = active & same_sign
        move_e = active & (~same_sign)
        b = torch.where(move_b, m, b)
        f_b = torch.where(move_b, f_m, f_b)
        e = torch.where(move_e, m, e)
        f_e = torch.where(move_e, f_m, f_e)
        m = _secant(b, e, f_b, f_e)
        f_m = f(m)
    return m
