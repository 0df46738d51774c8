"""O(n²) streaming reductions over the pairwise embedding kernel.

Counterpart of ``torchdr_tpu/ops/reduce.py``. :func:`pairwise_logkernel_rowlse`
is the row-wise log Σ_j k(‖z_i − z_j‖²) of t-SNE's and SNE's repulsion, a
``torch.autograd.Function`` whose forward is K2 and whose backward is K3
(``ops/cuda/reduce_kernel.py``), which recomputes the pairs from Z and the
forward's output: no n×n array is stored for the backward, or formed at
all on the card.

On a CUDA tensor both passes are the Hopper kernels at any n (the JAX
package takes its TPU kernels only from n = 1024, and its XLA tier below);
on a CPU tensor both are the plain versions, which are the JAX package's
blockwise XLA tier.

:func:`pairwise_logkernel_rowlse_sharded` splits the rows over a device
mesh (``parallel/mesh.Mesh``): each shard's device runs the general K2 on
its row chunk against the whole Z, and in the backward the general K3,
whose two outputs form that shard's (n, d) contribution; the contributions
are summed on Z's device in rank order (the JAX package's psum).

:func:`pairwise_logkernel_rowlse_autodiff` is the row log-sum for any
metric and any log-kernel (COSNE's hyperbolic Cauchy kernel): torch
operations over (block × n) tiles, each under
``torch.utils.checkpoint``, so that the backward recomputes a tile rather
than storing it and both passes hold O(block · n) memory. The JAX package
computes it in XLA too (``jax.checkpoint`` per tile).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import pad_to_multiple, replicate
from .cuda.reduce_kernel import (
    KERNELS,
    rowlse_bwd,
    rowlse_bwd_general,
    rowlse_fwd,
    rowlse_fwd_general,
)
from .metrics import pairwise_block

__all__ = [
    "KERNELS",
    "pairwise_logkernel_rowlse",
    "pairwise_logkernel_rowlse_sharded",
    "pairwise_logkernel_logsumexp",
    "pairwise_logkernel_rowlse_autodiff",
]


class _PairwiseLogkernelRowlse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, kernel, exclude_diag, block_size):
        out = rowlse_fwd(Z, kernel, exclude_diag, block_size)
        ctx.save_for_backward(Z, out)
        ctx.kernel = kernel
        ctx.block_size = block_size
        return out

    @staticmethod
    def backward(ctx, g):
        Z, out = ctx.saved_tensors
        dZ = rowlse_bwd(Z, out, g.contiguous(), ctx.kernel, ctx.block_size)
        return dZ, None, None, None


def pairwise_logkernel_rowlse(
    Z: torch.Tensor, kernel: str = "student", exclude_diag: bool = True, block_size: int = 1024
) -> torch.Tensor:
    """Row-wise logsumexp of ``log k(‖z_i − z_j‖²)`` without forming n×n.

    Returns a tensor of shape ``(n,)``, differentiable with respect to Z
    through the recomputing backward. ``logsumexp(result)`` gives t-SNE's
    repulsion; ``sum(result)`` gives SNE's.
    """
    return _PairwiseLogkernelRowlse.apply(Z.contiguous(), kernel, exclude_diag, block_size)


def _shards(Z, mesh):
    """Per shard: (device, row offset, the padded chunk of Z's rows, Z) on
    that device. Rows past n are zeros, which the kernels mask (n_total)."""
    n, d = Z.shape
    world = len(mesh)
    n_pad = pad_to_multiple(n, world)
    chunk = n_pad // world
    Zp = torch.zeros((n_pad, d), dtype=Z.dtype, device=Z.device)
    Zp[:n] = Z
    for r, (dev, Zdb) in enumerate(zip(mesh.devices, replicate(Z, mesh))):
        yield dev, r * chunk, Zp[r * chunk : (r + 1) * chunk].to(dev), Zdb


class _PairwiseLogkernelRowlseSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, mesh, kernel, exclude_diag, block_size):
        n = Z.shape[0]
        parts = [
            rowlse_fwd_general(Zq, Zdb, off, n, kernel, exclude_diag, block_size,
                               shard_of_db=True).to(Z.device)
            for _, off, Zq, Zdb in _shards(Z, mesh)
        ]
        out = torch.cat(parts)[:n]
        ctx.save_for_backward(Z, out)
        ctx.mesh, ctx.kernel = mesh, kernel
        ctx.exclude_diag, ctx.block_size = exclude_diag, block_size
        return out

    @staticmethod
    def backward(ctx, g):
        Z, out = ctx.saved_tensors
        n, world = Z.shape[0], len(ctx.mesh)
        chunk = pad_to_multiple(n, world) // world
        lse_p = torch.zeros((chunk * world,), dtype=out.dtype, device=Z.device)
        g_p = torch.zeros_like(lse_p)
        lse_p[:n], g_p[:n] = out, g
        dZ = None
        for dev, off, Zq, Zdb in _shards(Z, ctx.mesh):
            dZq, dZdb = rowlse_bwd_general(
                Zq, Zdb, off, n, lse_p[off : off + chunk].to(dev),
                g_p[off : off + chunk].contiguous().to(dev), ctx.kernel, ctx.exclude_diag,
                ctx.block_size,
            )
            # this shard's contribution: dZdb, with dZq added at its rows
            contrib = dZdb.to(Z.device)
            live = max(0, min(chunk, n - off))
            contrib[off : off + live] += dZq[:live].to(Z.device)
            # the psum, in rank order
            dZ = contrib if dZ is None else dZ + contrib
        return dZ, None, None, None, None


def pairwise_logkernel_rowlse_sharded(
    Z: torch.Tensor, mesh, kernel: str = "student", exclude_diag: bool = True,
    block_size: int = 1024,
) -> torch.Tensor:
    """Row-wise logsumexp of ``log k(‖z_i − z_j‖²)``, row-sharded over ``mesh``.

    The same function as :func:`pairwise_logkernel_rowlse`. Z (on any
    device) is padded to a multiple of the world size; shard r computes rows
    [r·chunk, (r+1)·chunk) on ``mesh.devices[r]`` with the general K2
    against Z[:n] (the padded rows masked), and in the backward the general
    K3. The result and the gradient land on Z's device.
    """
    return _PairwiseLogkernelRowlseSharded.apply(
        Z.contiguous(), mesh, kernel, exclude_diag, block_size
    )


def pairwise_logkernel_logsumexp(Z, kernel="student", exclude_diag=True, block_size=1024):
    """Global log Σ_ij k(‖z_i − z_j‖²) — t-SNE's exact repulsion term."""
    return torch.logsumexp(pairwise_logkernel_rowlse(Z, kernel, exclude_diag, block_size), dim=0)


def pairwise_logkernel_rowlse_autodiff(
    Z: torch.Tensor,
    log_kernel_fn,
    metric: str = "sqhyperbolic",
    exclude_diag: bool = True,
    block_size: int = 1024,
) -> torch.Tensor:
    """Row-wise logsumexp of ``log_kernel_fn(D)`` over the pairwise distances
    D of ``metric``, without forming n×n, differentiable by autograd.

    The rows go in blocks of ``min(block_size, max(8, n))``, the last padded
    with zero rows that are masked, as is the diagonal with
    ``exclude_diag``. Each (block × n) tile runs under a non-reentrant
    checkpoint: its forward saves nothing, and the backward recomputes it.
    ``log_kernel_fn`` maps a distance tile to the log-kernel elementwise
    (e.g. ``lambda D: math.log(g) - torch.log(D + g**2)``).
    """
    n = Z.shape[0]
    block = min(block_size, max(8, n))
    pad = (-n) % block
    Zp = torch.cat([Z, Z.new_zeros((pad, Z.shape[1]))]) if pad else Z
    base = torch.arange(block, device=Z.device)
    cols = torch.arange(n, device=Z.device)

    def tile(Zp, Z, start):
        rows = start + base
        logq = log_kernel_fn(pairwise_block(Zp[start : start + block], Z, metric))
        invalid = rows[:, None] >= n
        if exclude_diag:
            invalid = invalid | (rows[:, None] == cols[None, :])
        return torch.logsumexp(logq.masked_fill(invalid, float("-inf")), dim=1)

    out = [
        checkpoint(tile, Zp, Z, start, use_reentrant=False, preserve_rng_state=False)
        for start in range(0, Zp.shape[0], block)
    ]
    return torch.cat(out)[:n]
