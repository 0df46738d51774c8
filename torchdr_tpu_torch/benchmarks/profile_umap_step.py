"""The UMAP step's cost, part by part (counterpart of
``benchmarks/profile_umap_step.py``).

    python -m torchdr_tpu_torch.benchmarks.profile_umap_step [--n N] [--reps R]
        [--device auto|cpu]

Each part of the step is a function of plain torch operations, run eager as
the port's step runs them: the gather of each row's neighbours and their
sum, the indexed squared distance, the attraction (with two ``pow`` and
with one), the repulsion with its negatives drawn inside the call, and the
squared distance with its ``pow``. Shapes and constants are the JAX
script's: n = 60,000, 240 neighbours a row, 150 negatives, d = 2,
a = 1.577, b = 0.895. Each is timed as the JAX script times it (one
warm-up call, then the mean of 20 (``--reps``), each ending in a host read of
``[0, 0]``), less the same time of a trivial op (the cost of a dispatch
read back to the host); beside it, on a card, the mean CUDA-event time of
the same calls (the card's own time). Z, the neighbour ids and the
negatives come from a ``torch.Generator`` seeded 0: the JAX draws'
distributions, other numbers. The attraction takes P and does not read
it, as in the JAX script. ``main`` returns the readings and each part's
last output.

These are the JAX script's parts, at its width and with a row's own
negatives; the port's UMAP step runs K1 on shared negatives over a narrower
graph, and its device time by kernel and idle share come from
``chip_smoke.py --profile``.
"""

from __future__ import annotations

import argparse
import time

import torch

N, WIDTH, N_NEG, D = 60_000, 240, 150, 2
A, B = 1.577, 0.895
REPS = 20


def trivial(Z):
    return Z + 1.0


def gather_sum(Z, NN):
    return Z[NN].sum(1)


def sqdist(Z, NN):
    diff = Z[:, None, :] - Z[NN]
    return torch.sum(diff * diff, -1)


def attraction(Z, NN, P, a=A, b=B):
    D = sqdist(Z, NN)
    coef = 2 * a * b * D ** (b - 1.0) / (1.0 + a * D**b)
    coef = torch.where(D > 0, coef, 0.0)
    diff = Z[:, None, :] - Z[NN]
    return torch.clip(torch.einsum("ijk,ij->ik", diff, coef), -4, 4)


def attraction_1pow(Z, NN, P, a=A, b=B):
    D = sqdist(Z, NN)
    t = D**b
    coef = 2 * a * b * t / (torch.clamp(D, min=1e-12) * (1.0 + a * t))
    coef = torch.where(D > 0, coef, 0.0)
    diff = Z[:, None, :] - Z[NN]
    return torch.clip(torch.einsum("ijk,ij->ik", diff, coef), -4, 4)


def repulsion(Z, generator, n_neg=N_NEG, a=A, b=B, neg=None):
    """``neg`` given: those negatives; else drawn here, uniform over the rows."""
    if neg is None:
        neg = torch.randint(0, Z.shape[0], (Z.shape[0], n_neg), generator=generator,
                            device=Z.device)
    D = sqdist(Z, neg)
    coef = -2 * b / ((D + 1e-3) * (1.0 + a * D**b))
    diff = Z[:, None, :] - Z[neg]
    return torch.clip(torch.einsum("ijk,ij->ik", diff, coef), -4, 4)


def pow_only(Z, NN, b=B):
    return sqdist(Z, NN) ** b


def parts(Z, NN, P, generator, neg=None) -> tuple:
    """The seven timed calls, ``(label, fn)`` in the JAX script's order; the
    repulsion draws its negatives from ``generator`` unless ``neg`` is given."""
    return (
        ("dispatch overhead", lambda: trivial(Z)),
        (f"gather (n,{WIDTH},2) + sum", lambda: gather_sum(Z, NN)),
        ("indexed sqdist", lambda: sqdist(Z, NN)),
        ("attraction full", lambda: attraction(Z, NN, P)),
        ("attraction 1-pow", lambda: attraction_1pow(Z, NN, P)),
        ("repulsion full", lambda: repulsion(Z, generator, neg=neg)),
        ("sqdist+pow only", lambda: pow_only(Z, NN)),
    )


def inputs(n: int, width: int, device, seed: int = 0):
    """Z ~ N(0, 1) (n, D), neighbour ids uniform over the rows (n, width),
    P ~ U[0, 1) (n, width), from one generator seeded ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    Z = torch.randn(n, D, generator=g, device=device)
    NN = torch.randint(0, n, (n, width), generator=g, device=device)
    P = torch.rand(n, width, generator=g, device=device)
    return Z, NN, P, g


def timeit(fn, reps: int = REPS):
    """(host seconds, card seconds or None, last output) of one call: one
    warm-up, then the mean of ``reps`` calls, each read back at [0, 0]."""
    out = fn()
    float(out[0, 0])
    cuda = out.is_cuda
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)] if cuda else []
    t0 = time.perf_counter()
    for i in range(reps):
        if cuda:
            events[i][0].record()
        out = fn()
        if cuda:
            events[i][1].record()
        float(out[0, 0])
    host = (time.perf_counter() - t0) / reps
    card = sum(s.elapsed_time(e) for s, e in events) / reps / 1e3 if cuda else None
    return host, card, out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=N)
    parser.add_argument("--reps", type=int, default=REPS)
    parser.add_argument("--device", default="auto",
                        help="'auto' (the card, or raise without one) or 'cpu'")
    args = parser.parse_args(argv)

    from torchdr_tpu_torch.base import resolve_device
    from torchdr_tpu_torch.utils.wrappers import full_float32

    dev = resolve_device(args.device)
    n = args.n
    Z, NN, P, g = inputs(n, WIDTH, dev)
    readings, outputs = {}, {}
    with full_float32():  # the einsums: no TF32, as in the port's step
        for label, fn in parts(Z, NN, P, g):
            host, card, outputs[label] = timeit(fn, args.reps)
            readings[label] = {"host_ms": host * 1e3,
                               "device_ms": None if card is None else card * 1e3}
    overhead = readings["dispatch overhead"]["host_ms"]
    for label, r in readings.items():
        r["ms"] = r["host_ms"] if label == "dispatch overhead" else r["host_ms"] - overhead
        card = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f} ms"
        extra = (f" (pow ≈ {r['host_ms'] - readings['indexed sqdist']['host_ms']:.3f} ms)"
                 if label == "sqdist+pow only" else "")
        print(f"{label}: {r['ms']:.3f} ms{extra}; device {card}", flush=True)
    return {"n": n, "width": WIDTH, "n_neg": N_NEG, "readings": readings, "outputs": outputs}


if __name__ == "__main__":
    main()
