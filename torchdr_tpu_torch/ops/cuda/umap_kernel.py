"""K1: the fused shared-negative UMAP repulsion gradient.

Replaces the TPU kernel ``torchdr_tpu/ops/pallas/umap_kernel.py``
(``fused_shared_repulsion``, body ``_repulsion_kernel``). The CUDA source is
``ops/csrc/umap_repulsion.cu``; its note gives the bound on the card (the
n·S pairs' log, exp and divide, or launch latency at the UMAP path's size,
never memory: about 1.2 MB moves per call) and what the design does about
it (one row per thread, negatives staged in shared memory, no (n, S)
intermediate).

:func:`fused_shared_repulsion` launches the kernel for a CUDA tensor and
takes :func:`shared_repulsion_plain`, the same function in plain PyTorch,
only for a CPU tensor. It counts its launches in
``fused_shared_repulsion.launches``.

Both compute grad_i = clip(w_i · Σ_s coef_is (z_i − z_s), ±4), which is
the TPU kernel's (Σ_s coef) z_i − Σ_s coef z_s written without its float32
cancellation at near-collisions, with the sums over s in float64.
"""

from __future__ import annotations

import torch

from .build import load_function

#: largest embedding width the kernel is instantiated for
MAX_D = 8


def _check(Z, neg_ids, weight):
    if Z.ndim != 2 or Z.dtype != torch.float32:
        raise ValueError(f"Z must be a 2D float32 tensor, got {Z.dtype} {tuple(Z.shape)}.")
    n, d = Z.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"fused_shared_repulsion takes 1 <= d <= {MAX_D}, got d={d}.")
    if neg_ids.ndim != 1 or neg_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError("neg_ids must be a 1D integer tensor.")
    if weight.shape != (n,) or weight.dtype != torch.float32:
        raise ValueError(f"weight must be float32 of shape ({n},).")
    if not (neg_ids.device == weight.device == Z.device):
        raise ValueError("Z, neg_ids and weight must lie on one device.")
    if not (Z.is_contiguous() and weight.is_contiguous()):
        raise ValueError("Z and weight must be contiguous.")


def shared_repulsion_plain(Z, neg_ids, weight, a: float, b: float, eps: float = 1e-3,
                           chunk_pairs: int = 1 << 22):
    """The kernel's function in plain PyTorch, over (rows, S) chunks.

    Operation for operation the arithmetic of ``umap_repulsion.cu``, so the
    two agree on the card to the last bits of exp/log.
    """
    n, d = Z.shape
    neg_ids = neg_ids.long()
    S = neg_ids.shape[0]
    Zneg = Z[neg_ids]
    two_b = torch.tensor(-2.0 * b, dtype=Z.dtype)  # a tensor: one IEEE division
    out = torch.empty_like(Z)
    rows = max(1, chunk_pairs // max(1, S))
    for r0 in range(0, n, rows):
        Zb = Z[r0 : r0 + rows]
        diff = Zb[:, None, :] - Zneg[None, :, :]
        D = diff[..., 0] * diff[..., 0]
        for c in range(1, d):
            D = D + diff[..., c] * diff[..., c]
        t = torch.exp(b * torch.log(torch.clamp(D, min=1e-30)))
        coef = torch.div(two_b, (D + eps) * (1.0 + a * t))
        ids = torch.arange(r0, r0 + Zb.shape[0], device=Z.device)
        coef = torch.where(neg_ids[None, :] == ids[:, None], torch.zeros_like(coef), coef)
        g = (coef[:, :, None] * diff).double().sum(dim=1).float()
        out[r0 : r0 + rows] = torch.clamp(g * weight[r0 : r0 + rows, None], -4.0, 4.0)
    return out


def fused_shared_repulsion(Z, neg_ids, weight, a: float, b: float, eps: float = 1e-3):
    """Gradient of the shared-negative UMAP repulsion.

    Parameters
    ----------
    Z : (n, d) float32 embedding, 1 <= d <= 8, contiguous.
    neg_ids : (S,) integer ids of the shared negative sample. Any S: the
        JAX package takes its TPU kernel only for S % 128 == 0 (lane
        alignment), which has no meaning on the card.
    weight : (n,) float32 per-row weight (neg_counts · rate / S).
    a, b, eps : UMAP output-kernel constants.

    Returns the (n, d) float32 gradient, clipped to ±4. A CUDA tensor goes
    through the kernel (or raises); a CPU tensor through the plain version.
    """
    _check(Z, neg_ids, weight)
    if Z.device.type == "cpu":
        return shared_repulsion_plain(Z, neg_ids, weight, a, b, eps)
    if Z.device.type != "cuda":
        raise ValueError(f"fused_shared_repulsion: unsupported device {Z.device}.")
    fn = load_function("umap_repulsion")
    n, d = Z.shape
    neg_ids = neg_ids.long().contiguous()
    Zneg = Z.index_select(0, neg_ids)  # the (S, d) gather, in torch
    out = torch.empty_like(Z)
    stream = torch.cuda.current_stream(Z.device).cuda_stream
    with torch.cuda.device(Z.device):
        rc = fn(
            Z.data_ptr(), Zneg.data_ptr(), neg_ids.data_ptr(), weight.data_ptr(),
            out.data_ptr(), n, d, neg_ids.shape[0], float(a), float(b), float(eps),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"umap_shared_repulsion launch failed: cudaError {rc}.")
    fused_shared_repulsion.launches += 1
    return out


fused_shared_repulsion.launches = 0
