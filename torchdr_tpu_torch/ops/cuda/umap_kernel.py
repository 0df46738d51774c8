"""K1: the fused shared-negative UMAP repulsion gradient.

Replaces the TPU kernel ``torchdr_tpu/ops/pallas/umap_kernel.py``
(``fused_shared_repulsion``, body ``_repulsion_kernel``). The CUDA source is
``ops/csrc/umap_repulsion.cu``; its note gives the bound on the card (the
n·S pairs' logarithm, exponential and reciprocal, one special-function
result each, never memory: about 1.2 MB moves per call) and what the design
does about it (approximate lg2, ex2 and reciprocal, a row's negatives split
across lanes of a warp and merged by shuffles, two rows and eight
independent negatives per thread, float32 sums over runs of 16 then float64,
no id test for eps > 0, the sample gathered and staged in shared memory by
the kernel, no (n, S) intermediate).

:func:`fused_shared_repulsion` launches the kernel for a CUDA tensor and
takes :func:`shared_repulsion_plain`, the same function in plain PyTorch,
only for a CPU tensor. It counts its launches in
``fused_shared_repulsion.launches``. :func:`repulsion_grid` sizes the
kernel's grid in pure Python.

Both compute grad_i = clip(w_i · Σ_s coef_is (z_i − z_s), ±4), which is
the TPU kernel's (Σ_s coef) z_i − Σ_s coef z_s written without its float32
cancellation at near-collisions. The plain version rounds every operation
in float32 and sums in float64; the kernel differs from it by its
approximate special functions, its fused multiply-adds and its float32
runs, by up to 1.3e-5 where a negative lies within sqrt(eps) of a row
(``chip_smoke.py`` holds both to a float64 evaluation, and the kernel to
three times the plain version's distance from it).
"""

from __future__ import annotations

import torch

from .build import launch, load_function, sm_count

#: largest embedding width the kernel is instantiated for
MAX_D = 8

# The source's constants, which the grid below must agree with.
_THREADS = 128  # kThreads
_BLOCKS_PER_SM = 6  # kBlocksPerSM: resident blocks per SM, which the launch bounds allow for
# kMaxStaged, the most a block stages: an SM's 227 KB of shared memory, 1 KB
# of it reserved per block, holds that many blocks
_STAGED_BYTES = 227 * 1024 // _BLOCKS_PER_SM - 1024
_UNROLL = 8  # Shape<D>::kUnroll at d <= 2, half of it above: negatives a lane takes per step
_MAX_LANES = 32  # a row's negatives are split within one warp


def _check(Z, neg_ids, weight, row0, rows):
    if Z.ndim != 2 or Z.dtype != torch.float32:
        raise ValueError(f"Z must be a 2D float32 tensor, got {Z.dtype} {tuple(Z.shape)}.")
    n, d = Z.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"fused_shared_repulsion takes 1 <= d <= {MAX_D}, got d={d}.")
    if not 0 <= row0 <= row0 + rows <= n:
        raise ValueError(f"rows [{row0}, {row0 + rows}) do not lie in Z's {n} rows.")
    if neg_ids.ndim != 1 or neg_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError("neg_ids must be a 1D integer tensor.")
    if weight.shape != (rows,) or weight.dtype != torch.float32:
        raise ValueError(f"weight must be float32 of shape ({rows},).")
    if not (neg_ids.device == weight.device == Z.device):
        raise ValueError("Z, neg_ids and weight must lie on one device.")
    if not (Z.is_contiguous() and weight.is_contiguous()):
        raise ValueError("Z and weight must be contiguous.")


def rows_per_thread(d: int) -> int:
    """Rows of Z one thread owns (Shape<D>::kRows)."""
    return 2 if d <= 4 else 1


def record_bytes(d: int) -> int:
    """Bytes of one staged negative: z_s padded to an aligned vector."""
    return 4 * (1 if d == 1 else 2 if d == 2 else 4 if d <= 4 else 8)


def rows_per_tile(d: int, lanes: int) -> int:
    """Rows one block takes at a time when ``lanes`` lanes share a row."""
    return rows_per_thread(d) * _THREADS // lanes


def repulsion_grid(n: int, S: int, d: int, sm_count: int, masked: bool = False):
    """(lanes, blocks, s_tile) of the kernel's launch.

    ``lanes`` lanes of a warp share the negatives of the same rows: the
    fewest (a power of two) whose row tiles, one per block, fill three
    quarters of the blocks the card holds at once, while a lane keeps two
    full steps of the sample. Fewer leave SMs idle; more cost a staging of
    the sample and a merge for fewer rows each. At large n the rows alone
    fill the card and a thread walks the whole sample. The sample is staged
    ``s_tile`` negatives at a time: all of it where that fits the block's
    share of shared memory (with the ids, when ``masked``), else whole steps
    of a warp.
    """
    places = sm_count * _BLOCKS_PER_SM
    lanes = 1
    while (lanes < _MAX_LANES and S >= 4 * lanes * _UNROLL
           and 4 * -(-n // rows_per_tile(d, lanes)) < 3 * places):
        lanes *= 2
    step = _MAX_LANES * _UNROLL
    fits = _STAGED_BYTES // (record_bytes(d) + (4 if masked else 0)) // step * step
    return lanes, max(1, -(-n // rows_per_tile(d, lanes))), max(1, min(S, fits))


def shared_repulsion_plain(Z, neg_ids, weight, a: float, b: float, eps: float = 1e-3,
                           chunk_pairs: int = 1 << 22, mask_self: bool = True,
                           row0: int = 0, rows: int | None = None):
    """The kernel's function in plain PyTorch, over (rows, S) chunks: every
    operation rounded in Z's type, the sums over s in float64. On float64
    tensors it is the yardstick both versions are held to.

    ``mask_self=False`` leaves out the test s == i: for eps > 0 the term
    coef·(z_i − z_i) is 0 without it, which the kernel relies on.
    ``row0``, ``rows``: as :func:`fused_shared_repulsion`.
    """
    n, d = Z.shape
    rows = n - row0 if rows is None else rows
    neg_ids = neg_ids.long()
    S = neg_ids.shape[0]
    Zneg = Z[neg_ids]
    two_b = torch.tensor(-2.0 * b, dtype=Z.dtype)  # a tensor: one IEEE division
    out = torch.empty((rows, d), dtype=Z.dtype, device=Z.device)
    step = max(1, chunk_pairs // max(1, S))
    for i0 in range(0, rows, step):
        r0 = row0 + i0
        Zb = Z[r0 : row0 + min(rows, i0 + step)]
        diff = Zb[:, None, :] - Zneg[None, :, :]
        D = diff[..., 0] * diff[..., 0]
        for c in range(1, d):
            D = D + diff[..., c] * diff[..., c]
        t = torch.exp(b * torch.log(torch.clamp(D, min=1e-30)))
        coef = torch.div(two_b, (D + eps) * (1.0 + a * t))
        if mask_self:
            ids = torch.arange(r0, r0 + Zb.shape[0], device=Z.device)
            coef = torch.where(neg_ids[None, :] == ids[:, None], torch.zeros_like(coef), coef)
        g = (coef[:, :, None] * diff).double().sum(dim=1).to(Z.dtype)
        out[i0 : i0 + step] = torch.clamp(g * weight[i0 : i0 + step, None], -4.0, 4.0)
    return out


def fused_shared_repulsion(Z, neg_ids, weight, a: float, b: float, eps: float = 1e-3,
                           row0: int = 0, rows: int | None = None):
    """Gradient of the shared-negative UMAP repulsion.

    Parameters
    ----------
    Z : (n, d) float32 embedding, 1 <= d <= 8, contiguous.
    neg_ids : (S,) integer ids of the shared negative sample, each in
        [0, n); int64 and contiguous costs no conversion. Any S: the JAX
        package takes its TPU kernel only for S % 128 == 0 (lane alignment),
        which has no meaning on the card.
    weight : (rows,) float32 per-row weight (neg_counts · rate / S) of the
        rows computed.
    a, b, eps : UMAP output-kernel constants.
    row0, rows : the rows computed, ``[row0, row0 + rows)`` of Z (default
        all of them), each against the sample gathered from all of Z: a
        shard's rows on a mesh. A row's result does not depend on the range
        it is computed in: the grid takes its lanes from Z's n, so four
        ranges side by side give one launch's bits.

    Returns the (rows, d) float32 gradient, clipped to ±4. A CUDA tensor goes
    through the kernel (or raises); a CPU tensor through the plain version.
    """
    n, d = Z.shape
    rows = n - row0 if rows is None else int(rows)
    _check(Z, neg_ids, weight, row0, rows)
    if Z.device.type == "cpu":
        return shared_repulsion_plain(Z, neg_ids, weight, a, b, eps, row0=row0, rows=rows)
    if Z.device.type != "cuda":
        raise ValueError(f"fused_shared_repulsion: unsupported device {Z.device}.")
    fn = load_function("umap_repulsion")
    if neg_ids.dtype != torch.int64 or not neg_ids.is_contiguous():
        neg_ids = neg_ids.long().contiguous()
    S = neg_ids.shape[0]
    out = torch.empty((rows, d), dtype=Z.dtype, device=Z.device)
    if rows == 0:
        return out
    # eps <= 0: coef is infinite at D = 0, so the kernel tests the ids
    lanes, _, s_tile = repulsion_grid(n, S, d, sm_count(Z.device.index), masked=not eps > 0)
    rc = launch(
        fn, Z, Z.data_ptr(), neg_ids.data_ptr(), weight.data_ptr(), out.data_ptr(),
        row0, rows, d, S, s_tile, lanes, float(a), float(b), float(eps),
    )
    if rc != 0:
        raise RuntimeError(f"umap_shared_repulsion launch failed: cudaError {rc}.")
    fused_shared_repulsion.launches += 1
    return out


fused_shared_repulsion.launches = 0
