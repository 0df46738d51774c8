"""G1-G3: gathers of window-local ids from a window of rows.

Replace the TPU kernels of ``benchmarks/_gather_microbench.py``:
``bench_pl_take`` (G1), ``bench_pl_onehot`` (G2) and ``bench_pl_2level``
(G3). Each takes windows Zb (nb, R, D) float32 and ids idx (nb, 8, c8)
int32 in [0, R), the layout of those kernels (c = 8 c8 ids per window,
row-major), and gathers row idx[b, k] of window b:

- :func:`bucket_take` returns the rows exactly, as (nb, 8, c8, D);
- :func:`bucket_onehot` computes them as a one-hot bf16 product over the
  window with float32 sums, and so returns them rounded to bf16, as float32
  (nb, c, D);
- :func:`bucket_2level` (``grp`` rows a group, R % grp == 0) brings each
  row's group down by a one-hot bf16 product and selects the row within
  it: the same result as G2.

Every output element is one nonzero term, so kernel and plain version agree
bit for bit. The CUDA source is ``ops/csrc/bucket_gather.cu``; its note gives
the bound on the card (the bytes: ids, the window rows they touch and the
output, 1.037 GB at the microbenchmark's shape) and what the design does
about it. A wrapper launches its kernel for a CUDA tensor, and raises if
the launch fails, and takes its plain version (the ``*_plain`` functions:
``torch.gather`` on the window, plus the bf16 round trip for G2 and G3) only
for a CPU tensor. It counts its launches in ``.launches``. Ids out of [0, R) are outside the contract: both versions
clamp them to the window.
"""

from __future__ import annotations

import torch

from .build import launch, load_function

#: largest row width the kernels are instantiated for
MAX_D = 8


def _check(Zb, idx, name: str):
    if Zb.ndim != 3 or Zb.dtype != torch.float32:
        raise ValueError(f"{name}: Zb must be a 3D float32 tensor, got {Zb.dtype} {tuple(Zb.shape)}.")
    if idx.ndim != 3 or idx.dtype != torch.int32 or idx.shape[1] != 8:
        raise ValueError(f"{name}: idx must be an int32 tensor of shape (nb, 8, c8), got "
                         f"{idx.dtype} {tuple(idx.shape)}.")
    nb, r, d = Zb.shape
    if idx.shape[0] != nb:
        raise ValueError(f"{name}: Zb has {nb} windows and idx {idx.shape[0]}.")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name} takes 1 <= D <= {MAX_D}, got D={d}.")
    if r < 1:
        raise ValueError(f"{name}: a window needs at least one row.")
    if Zb.device != idx.device:
        raise ValueError(f"{name}: Zb and idx must lie on one device.")
    if not (Zb.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: Zb and idx must be contiguous.")
    if Zb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {Zb.device}.")


def _check_grp(r: int, grp: int):
    if grp < 1 or r % grp != 0:
        raise ValueError(f"bucket_2level needs R % grp == 0, got R={r}, grp={grp}.")


def _gather_rows(Zb, idx):
    """(nb, c, D): row idx[b, k] (clamped to the window) of window b."""
    nb, r, d = Zb.shape
    ids = idx.reshape(nb, idx.shape[1] * idx.shape[2]).long().clamp_(0, r - 1)
    return torch.gather(Zb, 1, ids[:, :, None].expand(-1, -1, d))


def bucket_take_plain(Zb, idx):
    """G1 in plain PyTorch: the gathered rows, (nb, 8, c8, D)."""
    nb, _, c8 = idx.shape
    return _gather_rows(Zb, idx).reshape(nb, 8, c8, Zb.shape[2])


def bucket_onehot_plain(Zb, idx):
    """G2 in plain PyTorch: the gathered rows rounded to bf16, (nb, c, D)."""
    return _gather_rows(Zb, idx).to(torch.bfloat16).float()


def bucket_2level_plain(Zb, idx, grp: int = 32):
    """G3 in plain PyTorch: the same function as G2, for R % grp == 0."""
    _check_grp(Zb.shape[1], grp)
    return bucket_onehot_plain(Zb, idx)


def _launch(wrapper, Zb, idx, out, *extra):
    """Launch the kernel of ``wrapper`` (its entry point has its name) and
    count the launch; nothing is launched for an empty output."""
    nb, r, d = Zb.shape
    c = idx.shape[1] * idx.shape[2]
    if nb == 0 or c == 0:
        return out
    name = wrapper.__name__
    fn = load_function("bucket_gather", name)
    rc = launch(fn, Zb, Zb.data_ptr(), idx.data_ptr(), out.data_ptr(), nb, r, d, c, *extra)
    if rc != 0:
        # the source refuses a staged window beyond a block's shared memory
        # with cudaErrorInvalidValue (1)
        why = ": the staged window does not fit a block's shared memory" if rc == 1 else ""
        raise RuntimeError(
            f"{name} launch failed with cudaError {rc} at nb={nb}, R={r}, D={d}, c={c}{why}.")
    wrapper.launches += 1
    return out


def bucket_take(Zb, idx):
    """G1: row idx[b, i, j] of window b, exactly, as (nb, 8, c8, D) float32.

    Zb (nb, R, D) float32, 1 <= D <= 8; idx (nb, 8, c8) int32 in [0, R);
    both contiguous. A CUDA tensor goes through the kernel (or raises), a CPU
    tensor through :func:`bucket_take_plain`.
    """
    _check(Zb, idx, "bucket_take")
    if Zb.device.type == "cpu":
        return bucket_take_plain(Zb, idx)
    nb, _, c8 = idx.shape
    return _launch(bucket_take, Zb, idx, Zb.new_empty((nb, 8, c8, Zb.shape[2])))


def bucket_onehot(Zb, idx):
    """G2: one-hot bf16 product over the window, float32 sums: the gathered
    rows rounded to bf16, as (nb, c, D) float32 in the row-major order of
    idx[b]. Inputs as :func:`bucket_take`; the kernel stages the window in
    shared memory and refuses a window that does not fit (R > 14,512)."""
    _check(Zb, idx, "bucket_onehot")
    if Zb.device.type == "cpu":
        return bucket_onehot_plain(Zb, idx)
    nb, _, d = Zb.shape
    return _launch(bucket_onehot, Zb, idx, Zb.new_empty((nb, idx.shape[1] * idx.shape[2], d)))


def bucket_2level(Zb, idx, grp: int = 32):
    """G3: a one-hot bf16 product that picks each row's group of ``grp``
    window rows, then a float32 one-hot select within the group; the same
    result as :func:`bucket_onehot`. Needs R % grp == 0; the kernel refuses
    staged groups that do not fit shared memory."""
    _check(Zb, idx, "bucket_2level")
    nb, r, d = Zb.shape
    _check_grp(r, grp)
    if Zb.device.type == "cpu":
        return bucket_2level_plain(Zb, idx, grp)
    out = Zb.new_empty((nb, idx.shape[1] * idx.shape[2], d))
    return _launch(bucket_2level, Zb, idx, out, grp)


bucket_take.launches = 0
bucket_onehot.launches = 0
bucket_2level.launches = 0
