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
blockwise XLA tier. The row-sharded variant waits for the multi-GPU slice,
and the autodiff variant for arbitrary kernels (COSNE's) for the COSNE
slice.
"""

from __future__ import annotations

import torch

from .cuda.reduce_kernel import KERNELS, rowlse_bwd, rowlse_fwd

__all__ = ["KERNELS", "pairwise_logkernel_rowlse", "pairwise_logkernel_logsumexp"]


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


def pairwise_logkernel_logsumexp(Z, kernel="student", exclude_diag=True, block_size=1024):
    """Global log Σ_ij k(‖z_i − z_j‖²) — t-SNE's exact repulsion term."""
    return torch.logsumexp(pairwise_logkernel_rowlse(Z, kernel, exclude_diag, block_size), dim=0)
