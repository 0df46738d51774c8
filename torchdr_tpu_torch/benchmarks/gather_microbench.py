"""Microbenchmark: gathers from a window of rows (G1-G3) against PyTorch's
dynamic gather, at the UMAP attraction shape (Z (n, 2) float32, NN (n, W)
int32).

Counterpart of ``benchmarks/_gather_microbench.py``. Its question: does a
kernel that gathers from a window of R consecutive rows, with ids local to
the window (what an edge list sorted by its tail provides), beat the
framework's dynamic gather? Variants:

  torch_gather  Z[NN].sum(1), the baseline (the JAX script's ``xla``)
  take          G1, ``bucket_take``: a direct indexed load from the window
  onehot        G2, ``bucket_onehot``: a one-hot bf16 product over the window
  2level        G3, ``bucket_2level``: a one-hot bf16 product that picks a
                group of 32 rows, then a float32 select within the group

Run on the card as

    python -m torchdr_tpu_torch.benchmarks.gather_microbench [variant ...]

It prints one JSON line per variant with ``variant``, ``edges``, ``ms`` (the
gather and the sum of its output, as the JAX script times them: one call to
warm up, then the mean of 20 calls between CUDA events), ``ns_per_idx`` and
``device``, and for G1-G3 ``kernel_ms`` (the kernel alone, timed the same
way), ``bound_ms`` (the bytes it must move over the card's memory rate:
the ids, the window rows they touch and the gathered rows) and
``library_ms`` (one ``torch.gather`` that computes the same function on the
bucketed layout: on the windows rounded to bf16 for G2 and G3, rounded
outside the timing). A variant that fails raises, and the module exits
non-zero. ``main(device="cpu", ...)`` runs any shape on the CPU through the
kernels' plain versions; its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..base import resolve_device
from ..ops.cuda.gather_kernel import bucket_2level, bucket_onehot, bucket_take

N = 1_300_000
W = 16  # edges per row visited (grouped-schedule width)
D = 8  # embedding dims padded to 8 (real d = 2)
R = 512  # window rows per bucket
C = 1024  # edges per window
REPS = 20
H100_BYTES_PER_S = 3.35e12  # HBM3 (data sheet)
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores (data sheet)


def make_bucketed(gen: torch.Generator, n_edges: int, d: int = D, r: int = R, c: int = C,
                  device="cpu"):
    """Windows Zb (nb, r, d) float32 and ids idx (nb, 8, c // 8) int32 in
    [0, r), nb = n_edges // c, drawn from ``gen`` on ``device``."""
    nb = n_edges // c
    Zb = torch.randn((nb, r, d), generator=gen, device=device)
    idx = torch.randint(0, r, (nb, 8, c // 8), generator=gen, device=device, dtype=torch.int32)
    return Zb, idx


def make_table(gen: torch.Generator, n: int = N, w: int = W, device="cpu"):
    """The baseline's Z (n, 2) float32 and NN (n, w) int32 in [0, n)."""
    Z = torch.randn((n, 2), generator=gen, device=device)
    NN = torch.randint(0, n, (n, w), generator=gen, device=device, dtype=torch.int32)
    return Z, NN


def run_torch_gather(Z, NN):
    return Z[NN].sum(1)


def run_take(Zb, idx):
    return bucket_take(Zb, idx).sum(dim=(0, 1, 2))


def run_onehot(Zb, idx):
    return bucket_onehot(Zb, idx).sum(dim=(0, 1))


def run_2level(Zb, idx):
    return bucket_2level(Zb, idx).sum(dim=(0, 1))


#: variant -> (the timed path, its kernel)
KERNELS = {
    "take": (run_take, bucket_take),
    "onehot": (run_onehot, bucket_onehot),
    "2level": (run_2level, bucket_2level),
}
VARIANTS = ("torch_gather", *KERNELS)


def timeit(fn, *args, reps: int = REPS) -> float:
    """Milliseconds per call of ``fn(*args)``: one call to warm up, then the
    mean of ``reps`` calls, between CUDA events on the card and on the host
    clock on the CPU."""
    fn(*args)
    if args[0].device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def touched_rows(idx, r: int) -> int:
    """Distinct window rows that the ids (nb, 8, c8) touch, summed over the
    windows: the rows a gather must read."""
    nb = idx.shape[0]
    hit = torch.zeros((nb, r), dtype=torch.bool, device=idx.device)
    hit.scatter_(1, idx.reshape(nb, -1).long().clamp_(0, r - 1), True)
    return int(hit.sum())


def bound_ms(nb: int, r: int, d: int, c: int, rows: int, variant: str) -> tuple:
    """Least time of a kernel's work on an H100: the larger of its bytes
    over the memory rate (the ids and the ``rows`` window rows they touch
    read once, the gathered rows written once) and the one-hot product's
    2cRd operations a window over the bf16 tensor-core rate (G2, G3; G1
    does none). Returns (ms, "bytes" or "operations")."""
    t_bytes = 4 * (nb * c + rows * d + nb * c * d) / H100_BYTES_PER_S * 1e3
    t_ops = 0.0 if variant == "take" else 2 * nb * c * r * d / H100_BF16_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def library_args(variant: str, Zb, idx) -> tuple:
    """The arguments of the one ``torch.gather`` that computes the variant's
    function on the bucketed layout: the windows (rounded to bf16 for G2 and
    G3), 1, and the ids as an int64 index over the row's coordinates."""
    nb, _, d = Zb.shape
    ids = idx.reshape(nb, idx.shape[1] * idx.shape[2]).long()[:, :, None].expand(-1, -1, d)
    table = Zb if variant == "take" else Zb.to(torch.bfloat16).float()
    return table, 1, ids


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(variants=(), device="auto", n: int = N, w: int = W, d: int = D, r: int = R,
         c: int = C, seed: int = 0, reps: int = REPS) -> list:
    """Time the variants named in ``variants`` (all when empty) and print
    one JSON line each; returns the records."""
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; choose from {VARIANTS}.")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_edges = n * w
    name = _device_name(device)
    records = []

    def emit(record):
        print(json.dumps(record), flush=True)
        records.append(record)

    if not variants or "torch_gather" in variants:
        Z, NN = make_table(gen, n, w, device)
        ms = timeit(run_torch_gather, Z, NN, reps=reps)
        emit({"variant": "torch_gather", "edges": n_edges, "ms": ms,
              "ns_per_idx": ms * 1e6 / n_edges, "device": name})
        del Z, NN

    Zb, idx = make_bucketed(gen, n_edges, d, r, c, device)
    nb = Zb.shape[0]
    rows = touched_rows(idx, r)
    for variant, (run, kernel) in KERNELS.items():
        if variants and variant not in variants:
            continue
        ms = timeit(run, Zb, idx, reps=reps)
        kernel_ms = timeit(kernel, Zb, idx, reps=reps)
        library_ms = timeit(torch.gather, *library_args(variant, Zb, idx), reps=reps)
        bound, bound_by = bound_ms(nb, r, d, c, rows, variant)
        emit({"variant": variant, "edges": n_edges, "ms": ms,
              "ns_per_idx": ms * 1e6 / n_edges, "device": name, "kernel_ms": kernel_ms,
              "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms})
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", help=f"any of {VARIANTS}; all by default")
    main(parser.parse_args().variants)
