"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the main path, from the sources in the
   checkout (one nvcc per source, started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes plus edge cases, with its time, the plain
   version's time and its bound;
4. fit: ``UMAP(random_state=0).fit_transform(X)`` on 60,000 x 784 float32
   synthetic data (50 Gaussian clusters, seeded), with every kernel launch
   counter set to 0 just before and read just after; phase times, peak
   memory, launches, NaN check and a 10-NN label accuracy of the embedding;
5. with ``--profile`` only: device time by kernel and the device's idle
   share over 200 optimizer steps of the same fit (torch.profiler).

It prints one JSON line of kernel records, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N, D_IN, N_CLUSTERS, SEED = 60_000, 784, 50, 0
S_MAIN = 512  # shared negatives of the UMAP path at n = 60k
TOL = 1e-5  # max |kernel - plain|: same arithmetic, float64 sums in both
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 50) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound_ms(n: int, S: int, d: int) -> tuple:
    """Least time for K1's work on an H100: the larger of its bytes over
    memory rate (Z, w, ids read once; out written once) and its float32
    operations over the float32 rate, counting each of the 5d + 10
    operations per pair (exp, log and divide as one each) once."""
    bytes_moved = 4 * n * d + 4 * n + 8 * S + 4 * n * d
    ops = n * S * (5 * d + 10)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_k1(torch, gen, a: float, b: float) -> dict:
    from torchdr_tpu_torch.ops.cuda.umap_kernel import (
        fused_shared_repulsion,
        shared_repulsion_plain,
    )

    dev = torch.device("cuda")
    worst = 0.0
    cases = [
        ("main d=2", N, S_MAIN, 2, False),
        ("main d=3", N, S_MAIN, 3, False),
        ("ragged n", N - 37, S_MAIN, 2, False),
        ("self-collisions", N, S_MAIN, 2, True),
    ]
    for label, n, S, d, collide in cases:
        Z = (3.0 * torch.randn((n, d), generator=gen, device=dev)).contiguous()
        neg = (
            torch.arange(S, device=dev)
            if collide
            else torch.randint(0, n, (S,), generator=gen, device=dev)
        )
        w = torch.randint(0, 600, (n,), generator=gen, device=dev).float() / S
        got = fused_shared_repulsion(Z, neg, w, a, b)
        ref = shared_repulsion_plain(Z, neg, w, a, b)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        print(f"K1 {label}: n={n} S={S} d={d} max|kernel-plain|={err:.3e}", flush=True)
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"K1 {label}: max abs err {err} > {TOL}")
        worst = max(worst, err)

    n, S, d = N, S_MAIN, 2
    Z = (3.0 * torch.randn((n, d), generator=gen, device=dev)).contiguous()
    neg = torch.randint(0, n, (S,), generator=gen, device=dev)
    w = torch.randint(0, 600, (n,), generator=gen, device=dev).float() / S
    ms = cuda_time_ms(lambda: fused_shared_repulsion(Z, neg, w, a, b), reps=200)
    plain_ms = cuda_time_ms(lambda: shared_repulsion_plain(Z, neg, w, a, b), reps=20)
    bound_ms, bound_by = k1_bound_ms(n, S, d)
    print(
        f"K1 time n={n} S={S} d={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})",
        flush=True,
    )
    return {
        "name": "umap_shared_repulsion (K1)",
        "route": "cuda",
        "source": "torchdr_tpu_torch/ops/csrc/umap_repulsion.cu",
        "replaces": "torchdr_tpu/ops/pallas/umap_kernel.py:68",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def knn_label_accuracy(torch, Z, labels, n_sub: int = 10_000, k: int = 10, seed: int = 0):
    """10-NN majority-label accuracy of the embedding on a row subsample."""
    g = torch.Generator(device=Z.device)
    g.manual_seed(seed)
    idx = torch.randperm(Z.shape[0], generator=g, device=Z.device)[:n_sub]
    Zs, ys = Z[idx], labels[idx]
    D = torch.cdist(Zs, Zs)
    D.fill_diagonal_(float("inf"))
    nn = torch.topk(D, k, dim=1, largest=False).indices
    votes = torch.nn.functional.one_hot(ys[nn], int(labels.max()) + 1).sum(1)
    return float((votes.argmax(1) == ys).float().mean())


def profile_optimize(torch, X, steps: int = 200, top: int = 8, device: str = "auto") -> dict:
    """Device time by kernel over ``steps`` optimizer steps of the 60k fit
    (torch.profiler), and the device's busy share of that window's wall
    time. The affinity and init phases run first, outside the window."""
    from torch.profiler import ProfilerActivity, profile

    from torchdr_tpu_torch import UMAP

    model = UMAP(random_state=0, max_iter=steps, device=device)
    Xd = torch.from_numpy(X).to(model._resolve_device())
    model.n_samples_in_, model.n_features_in_ = Xd.shape
    model._generator_ = model._root_generator()
    model._compute_input_affinity(Xd)
    model.on_affinity_computation_end()
    Z0 = model._init_embedding(Xd)
    consts = model._build_consts(Xd)
    carry0 = model._init_carry(consts)
    model._optimize(Z0, consts, carry0)  # warm-up, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model._optimize(Z0, consts, carry0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0.0
        )

    # device-side events only (kernels, copies): an aten op's own row
    # repeats the time of the kernels it launched
    kernels = [
        e for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0
    ]
    kernels.sort(key=device_us, reverse=True)
    busy_s = sum(device_us(e) for e in kernels) / 1e6
    return {
        "steps": steps,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_s / steps * 1e3,
        "device_idle_share": 1.0 - busy_s / wall,
        "top_kernels_ms_per_step": {
            e.key[:60]: device_us(e) / 1e3 / steps for e in kernels[:top]
        },
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torchdr_tpu_torch  # noqa: F401  (sets TF32 off)
    from torchdr_tpu_torch import UMAP
    from torchdr_tpu_torch.models.neighbor.umap import find_ab_params
    from torchdr_tpu_torch.ops.cuda.build import build_libraries
    from torchdr_tpu_torch.ops.cuda.umap_kernel import fused_shared_repulsion

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)
    print(
        f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
        flush=True,
    )

    # 2. build
    t0 = time.perf_counter()
    libs = build_libraries()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k1 = check_k1(torch, gen, *find_ab_params(1.0, 0.1))  # UMAP's defaults

    # 4. the slice: UMAP fit on 60k x 784
    rng = np.random.default_rng(SEED)
    centers = rng.normal(scale=4.0, size=(N_CLUSTERS, D_IN)).astype(np.float32)
    labels = rng.integers(0, N_CLUSTERS, N)
    X = centers[labels] + rng.standard_normal((N, D_IN), dtype=np.float32)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_shared_repulsion.launches = 0
    t0 = time.perf_counter()
    model = UMAP(random_state=0, device="auto")
    Z = model.fit_transform(X)
    wall = time.perf_counter() - t0
    launches = fused_shared_repulsion.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k1["launches"] = launches

    if Z.shape != (N, 2) or not np.all(np.isfinite(Z)):
        raise AssertionError(f"embedding has shape {Z.shape} or non-finite values")
    if launches != model.n_iter_ or launches == 0:
        raise AssertionError(f"K1 launched {launches} times in {model.n_iter_} steps")
    Zt = torch.from_numpy(Z).cuda()
    acc = knn_label_accuracy(torch, Zt, torch.from_numpy(labels).cuda())
    fit = {
        "n": N, "d": D_IN, "steps": model.n_iter_, "wall_s": wall,
        "phases_s": model.timings_, "peak_mem_gb": peak_gb,
        "k1_launches": launches, "knn10_label_acc": acc,
    }
    print("fit " + json.dumps(fit), flush=True)
    if acc < 0.9:
        raise AssertionError(f"10-NN label accuracy {acc} < 0.9")

    if "--profile" in sys.argv[1:]:
        print("profile " + json.dumps(profile_optimize(torch, X)), flush=True)

    print(json.dumps({"kernels": [k1]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
