"""The attraction of the entropic neighbor embeddings (t-SNE, SNE) over the
kNN edges, as gathers only.

:func:`knn_transpose` lists, once a fit, each row's in-edges. With them,
:func:`knn_attraction_loss` is Σ_i Σ_{j∈NN(i)} P_ij φ(‖z_i − z_j‖²)
(φ = log1p for ``"student"``, the identity for ``"gaussian"``), a
``torch.autograd.Function`` whose forward is one launch of A1
(``ops/cuda/attraction_kernel.py``) computing the loss and its gradient,
with no scatter, and whose backward scales that gradient. Its value is the
cross-entropy ``-Σ P log Q`` of the kNN edges with log Q = −φ(d), up to the
order of the float32 sums.
"""

from __future__ import annotations

import torch

from .cuda.attraction_kernel import tsne_attraction

__all__ = ["knn_transpose", "knn_attraction_loss"]


def knn_transpose(NN: torch.Tensor, P: torch.Tensor):
    """The kNN graph ``NN`` (n, k) with weights ``P`` (n, k), seen from the
    other end of each edge, for A1.

    Returns ``(in_ptr, in_src, in_P)``: row j's in-edges, the edges i → j,
    are ``in_src[in_ptr[j]:in_ptr[j + 1]]`` (int32, the rows i in
    increasing order, once per edge) with their weights ``in_P`` (P_ij, in
    P's dtype); ``in_ptr`` is (n + 1,) int64. Pads (ids below 0) are left
    out. A stable sort of the flat ids, so the lists are the same on every
    run.
    """
    n, k = NN.shape
    flat = NN.reshape(-1).long()
    keys = torch.where(flat >= 0, flat, n)  # pads sort last
    order = torch.sort(keys, stable=True).indices
    in_ptr = torch.zeros(n + 1, dtype=torch.int64, device=NN.device)
    in_ptr[1:] = torch.cumsum(torch.bincount(keys, minlength=n + 1)[:n], 0)
    order = order[: int(in_ptr[-1])]
    in_src = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    return in_ptr, in_src, P.reshape(-1)[order]


class _KnnAttraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, NN, P, in_ptr, in_src, in_P, kernel):
        grad, row_loss = tsne_attraction(Z, NN, P, (in_ptr, in_src, in_P), kernel,
                                         grad=ctx.needs_input_grad[0])
        ctx.save_for_backward(grad)
        return torch.sum(row_loss)

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None, None, None, None, None


def knn_attraction_loss(Z, P, NN, transpose, kernel: str = "student"):
    """Σ_i Σ_{j∈NN(i)} P_ij φ(‖z_i − z_j‖²), differentiable with respect to
    Z (and through Z to whatever made it).

    ``transpose`` is :func:`knn_transpose` of ``(NN, P)``. Z is a float32
    CUDA tensor with 1 <= d <= 8. The forward is one launch of A1, which
    writes the gradient beside the loss (when Z needs one), and the backward
    multiplies it by the incoming gradient.
    """
    return _KnnAttraction.apply(Z, NN, P, *transpose, kernel)
