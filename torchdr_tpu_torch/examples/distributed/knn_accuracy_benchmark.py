"""kNN label accuracy over the mesh (counterpart of
``examples/distributed/knn_accuracy_benchmark.py``).

The mesh: every card when the machine has several, else four shards of the
one card; on the CPU (``--device cpu``), ``VIRTUAL_CPU_DEVICES_ENV`` CPU
devices, 8 when unset.

Run: python -m torchdr_tpu_torch.examples.distributed.knn_accuracy_benchmark [--n N] [--device cpu]

Gate: besides the fit's, the single-device and mesh accuracies equal.
"""

import time

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, example_mesh, parser, timed_fit

SCRIPT = "distributed/knn_accuracy_benchmark"


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=20_000)  # the JAX script's size
    args = p.parse_args(argv)
    dev = args.device
    mesh = example_mesh(dev)
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(10, 32))
    y = rng.integers(0, 10, args.n)
    X = (centers[y] + rng.normal(size=(args.n, 32))).astype(np.float32)

    Z, seconds = timed_fit(tdt.UMAP(n_neighbors=15, max_iter=200, random_state=0,
                                    distributed=True, mesh=mesh, device=dev), X)

    t0 = time.perf_counter()
    acc_single = tdt.knn_label_accuracy(Z, y, k=10, device=dev)
    t1 = time.perf_counter()
    acc_mesh = tdt.knn_label_accuracy(Z, y, k=10, mesh=mesh, device=dev)
    t2 = time.perf_counter()
    print(f"knn label accuracy: single {acc_single:.4f} ({t1 - t0:.2f}s) | "
          f"mesh {acc_mesh:.4f} ({t2 - t1:.2f}s) on {len(mesh)} devices")

    fit = {"embedding": Z, "labels": y, "seconds": seconds, "knn_acc": acc_single,
           "knn_acc_mesh": acc_mesh, "single_s": t1 - t0, "mesh_s": t2 - t1}
    check_fit(SCRIPT, "UMAP", fit)
    if acc_mesh != acc_single:
        raise AssertionError(f"{SCRIPT}: mesh accuracy {acc_mesh} != single {acc_single}")
    return {"fits": {"UMAP": fit}, "n_devices": len(mesh)}


if __name__ == "__main__":
    main()
