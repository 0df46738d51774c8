"""Neighbourhood preservation over the mesh: UMAP vs LargeVis (counterpart
of ``examples/distributed/neighborhood_preservation_benchmark.py``).

The mesh: every card when the machine has several, else four shards of the
one card; on the CPU (``--device cpu``), ``VIRTUAL_CPU_DEVICES_ENV`` CPU
devices, 8 when unset.

Run: python -m torchdr_tpu_torch.examples.distributed.neighborhood_preservation_benchmark [--n N] [--device cpu]
"""

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, example_mesh, parser, timed_fit

SCRIPT = "distributed/neighborhood_preservation_benchmark"


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=10_000)  # the JAX script's size
    args = p.parse_args(argv)
    dev = args.device
    mesh = example_mesh(dev)
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=6.0, size=(12, 32))
    y = rng.integers(0, 12, args.n)
    X = (centers[y] + rng.normal(size=(args.n, 32))).astype(np.float32)

    fits = {}
    for name, model in {
        "UMAP": tdt.UMAP(n_neighbors=15, max_iter=300, random_state=0,
                         distributed=True, mesh=mesh, device=dev),
        "LargeVis": tdt.LargeVis(perplexity=15, max_iter=300, random_state=0,
                                 distributed=True, mesh=mesh, device=dev),
    }.items():
        Z, dt = timed_fit(model, X)
        pres = tdt.neighborhood_preservation(X, Z, K=15, mesh=mesh, device=dev)
        print(f"{name:9s} fit {dt:6.1f}s  preservation@15 = {pres:.4f}")
        fits[name] = {"embedding": Z, "labels": y, "seconds": dt, "preservation": pres,
                      "knn_acc": tdt.knn_label_accuracy(Z, y, k=10, device=dev)}
    for name, fit in fits.items():
        check_fit(SCRIPT, name, fit)
    return {"fits": fits, "n_devices": len(mesh)}


if __name__ == "__main__":
    main()
