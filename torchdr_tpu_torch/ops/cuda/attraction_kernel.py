"""A1: t-SNE's and SNE's attraction over the kNN edges and their transpose.

Replaces no TPU kernel: the JAX package takes the attraction's gradient by
autograd of the gather ``Z[NN]``, and so did the port, whose backward on the
card was a sort of the n·k ids and a segmented sum every step. The CUDA
source is ``ops/csrc/tsne_attraction.cu``; its note gives the bound on the
card (the edges' ids and weights read from both ends, about 103 MB at
70,000 × 90, and the gathers of the other ends' rows of Z, which set its
pace) and what the design does about it (a warp a row over its out-edges
then its in-edges, several gathers in flight a lane, a fixed butterfly of
shuffles, no atomics).

For Z (n, d), the kNN graph ``NN`` (n, k) with weights ``P`` (n, k) (ids
below 0 are pads) and ``transpose`` = (``in_ptr``, ``in_src``, ``in_P``)
from ``ops/attraction.knn_transpose`` (each row's in-edges), with
φ = log1p (``"student"``) or the identity (``"gaussian"``):

- loss_i = Σ_{j∈NN(i)} P_ij φ(‖z_i − z_j‖²);
- grad_i = 2 Σ_{j∈NN(i)} P_ij φ′(d_ij) (z_i − z_j)
  + 2 Σ_{e ∈ in(i)} in_P_e φ′(d_e) (z_i − z_src(e)), the gradient of
  Σ_i loss_i: every edge pulls both of its ends.

:func:`tsne_attraction` launches the kernel on a CUDA tensor and counts its
launches in ``tsne_attraction.launches``. :func:`tsne_attraction_plain` is
the same formula in torch operations, which the tests hold the kernel to.
"""

from __future__ import annotations

import torch

from .build import launch, load_function

KERNELS = ("student", "gaussian")
MAX_D = 8  # the widths the kernel takes: 1 to MAX_D, as K1, K2 and K3


def _phi(dist, kernel):
    """(φ(d), φ′(d))."""
    if kernel == "gaussian":
        return dist, torch.ones_like(dist)
    return torch.log1p(dist), 1.0 / (1.0 + dist)


def tsne_attraction_plain(Z, NN, P, transpose, kernel="student"):
    """A1's function in torch operations, in Z's dtype: (grad, loss per
    row). The in-edges' terms are added by ``index_add_``."""
    in_ptr, in_src, in_P = transpose
    valid = NN >= 0
    zero = torch.zeros((), dtype=Z.dtype, device=Z.device)
    Pm = torch.where(valid, P.to(Z.dtype), zero)
    diff = Z[:, None, :] - Z[torch.clamp(NN, min=0).long()]
    phi, dphi = _phi(torch.sum(diff * diff, dim=-1), kernel)
    row_loss = torch.sum(Pm * phi, dim=1)
    g = torch.sum((Pm * dphi)[..., None] * diff, dim=1)
    dst = torch.repeat_interleave(
        torch.arange(Z.shape[0], device=Z.device), torch.diff(in_ptr.long()))
    diff_in = Z[dst] - Z[in_src.long()]
    _, dphi_in = _phi(torch.sum(diff_in * diff_in, dim=-1), kernel)
    g.index_add_(0, dst, (in_P.to(Z.dtype) * dphi_in)[:, None] * diff_in)
    return 2.0 * g, row_loss


def _check(Z, NN, P, transpose, kernel):
    if kernel not in KERNELS:
        raise ValueError(f"[TorchDR-Torch] unknown kernel {kernel!r}; expected one of {KERNELS}.")
    in_ptr, in_src, in_P = transpose
    if Z.ndim != 2 or NN.ndim != 2 or P.shape != NN.shape or NN.shape[0] != Z.shape[0]:
        raise ValueError(f"tsne_attraction: Z {tuple(Z.shape)}, NN {tuple(NN.shape)} and "
                         f"P {tuple(P.shape)} do not fit.")
    if in_ptr.shape != (Z.shape[0] + 1,) or in_src.shape != in_P.shape or in_src.ndim != 1:
        raise ValueError(f"tsne_attraction: in_ptr {tuple(in_ptr.shape)}, in_src "
                         f"{tuple(in_src.shape)} and in_P {tuple(in_P.shape)} do not fit.")


def tsne_attraction(Z, NN, P, transpose, kernel="student", grad=True):
    """The attraction's gradient (n, d) (None when ``grad`` is False) and its
    loss per row (n,), float32, by one launch of A1.

    Z, P and ``in_P`` are float32 CUDA tensors, 1 <= d <= ``MAX_D``; ids
    that are not int32 are cast (a fit's kNN ids are int32 already).
    """
    _check(Z, NN, P, transpose, kernel)
    n, d = Z.shape
    if Z.device.type != "cuda":
        raise ValueError(f"tsne_attraction: unsupported device {Z.device}.")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"tsne_attraction takes 1 <= d <= {MAX_D} on the card, got d={d}.")
    in_ptr, in_src, in_P = transpose
    if any(t.dtype != torch.float32 for t in (Z, P, in_P)):
        raise ValueError("tsne_attraction: Z, P and in_P must be float32.")
    if not Z.is_contiguous() or Z.data_ptr() % 8:
        Z = Z.clone(memory_format=torch.contiguous_format)  # a fresh allocation is aligned
    NN, in_src = (t.to(torch.int32).contiguous() for t in (NN, in_src))
    P, in_P = P.contiguous(), in_P.contiguous()
    in_ptr = in_ptr.to(torch.int64).contiguous()
    g = torch.empty_like(Z) if grad else None
    row_loss = torch.empty((n,), dtype=torch.float32, device=Z.device)
    if n == 0:
        return g, row_loss
    rc = launch(
        load_function("tsne_attraction"), Z, Z.data_ptr(), NN.data_ptr(), P.data_ptr(),
        in_ptr.data_ptr(), in_src.data_ptr(), in_P.data_ptr(), g.data_ptr() if grad else None,
        row_loss.data_ptr(), n, NN.shape[1], d, int(kernel == "gaussian"),
    )
    if rc != 0:
        raise RuntimeError(f"tsne_attraction launch failed: cudaError {rc}.")
    tsne_attraction.launches += 1
    return g, row_loss


tsne_attraction.launches = 0
