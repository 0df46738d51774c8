"""Faults planted in the timed path underneath the harness, which ``correct``
has to fail (not run by the benchmark's runs).

- ``state_unchanged``: the optimizer's step returns the embedding and its
  state as they were;
- ``half_the_batch``: UMAP's repulsion over half the shared negatives at
  twice the weight; t-SNE's repulsion over half the rows' log-sums, their
  mean taken over the rest (the other rows enter only as columns);
- ``half_the_columns`` (t-SNE): each row's log-sum over half the columns,
  twice their mean, at the last two steps, where the check reads (plain
  torch in blocks; over every step it would take minutes a fit at 70,000
  rows);
- ``answer_altered``: one row of the embedding ``fit_transform`` returns
  moved by 1.

A one-chip cell exchanges nothing between chips, so that fault has no place
here. ``planted(name, estimator)`` plants one for a ``with`` block; the
tests plant them on the CPU at a small size, and ``python3 -m
perfbench.control --faults <name>,...`` at a cell's own size on the card.
"""

from __future__ import annotations

import contextlib
import math
from unittest import mock

import torch
from torch.utils.checkpoint import checkpoint


def state_unchanged(estimator: str):
    from torchdr_tpu_torch.utils import optim

    init, _ = optim._OPTIMIZERS["SGD"]
    return mock.patch.dict(optim._OPTIMIZERS,
                           {"SGD": (init, lambda g, state, params, lr, hyper: (params, state))})


def half_the_batch(estimator: str):
    if estimator == "UMAP":
        from torchdr_tpu_torch.models.neighbor import umap

        full = umap.fused_shared_repulsion

        def half(Z, neg, w, a, b, eps=1e-3):
            return full(Z, neg[: neg.shape[0] // 2].contiguous(), 2.0 * w, a, b, eps)

        return mock.patch.object(umap, "fused_shared_repulsion", half)
    from torchdr_tpu_torch.models.neighbor import tsne

    full = tsne.pairwise_logkernel_rowlse

    def half(Z, kernel, exclude_diag, block_size):
        out = full(Z, kernel, exclude_diag, block_size)
        kept = torch.arange(out.shape[0], device=out.device) % 2 == 0
        return torch.where(kept, out + math.log(2.0), torch.full_like(out, -math.inf))

    return mock.patch.object(tsne, "pairwise_logkernel_rowlse", half)


def _half_columns(Z: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Each row's log Σ over the even columns j ≠ i of (1 + |z_i − z_j|²)⁻¹, plus log 2."""
    cols = Z[0::2]
    ids = 2 * torch.arange(cols.shape[0], device=Z.device)

    def tile(Zb, cols, start):
        logq = -torch.log1p((Zb[:, None, :] - cols[None, :, :]).square().sum(-1))
        own = (start + torch.arange(Zb.shape[0], device=Z.device))[:, None] == ids[None, :]
        return torch.logsumexp(logq.masked_fill(own, -math.inf), dim=1)

    out = [checkpoint(tile, Z[s: s + block], cols, s, use_reentrant=False)
           for s in range(0, Z.shape[0], block)]
    return torch.cat(out) + math.log(2.0)


def half_the_columns(estimator: str):
    from torchdr_tpu_torch.models.neighbor import tsne

    full = tsne.TSNE._repulsive_loss

    def repulsion(self, Z, consts, carry, it):
        if it < int(self.max_iter) - 2:
            return full(self, Z, consts, carry, it)
        return torch.logsumexp(_half_columns(Z), dim=0), carry

    return mock.patch.object(tsne.TSNE, "_repulsive_loss", repulsion)


def answer_altered(estimator: str):
    from torchdr_tpu_torch import base

    restore = base.restore_format

    def altered(Z, fmt):
        out = restore(Z, fmt).copy()
        out[7] += 1.0
        return out

    return mock.patch.object(base, "restore_format", altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_batch, half_the_columns,
                                   answer_altered)}
#: the faults that only one estimator can have
ONLY = {"half_the_columns": "TSNE"}


def names(estimator: str) -> list:
    """The faults a cell of ``estimator`` can have."""
    return [n for n in FAULTS if ONLY.get(n, estimator) == estimator]


@contextlib.contextmanager
def planted(name: str, estimator: str):
    """The fault ``name`` in the program for the block, for ``estimator``
    (``"UMAP"`` or ``"TSNE"``)."""
    with FAULTS[name](estimator):
        yield
