"""UMAP over a device mesh (counterpart of
``examples/distributed/distributed_umap.py``).

The mesh: every card when the machine has several, else four shards of the
one card; on the CPU (``--device cpu``, in place of the JAX script's
``--cpu``), ``VIRTUAL_CPU_DEVICES_ENV`` CPU devices, 8 when unset.

Run: python -m torchdr_tpu_torch.examples.distributed.distributed_umap [--n 4096] [--device cpu]
"""

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, example_mesh, parser, timed_fit

SCRIPT = "distributed/distributed_umap"


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=4096)
    args = p.parse_args(argv)
    dev = args.device

    mesh = example_mesh(dev)
    print(f"mesh: {mesh}")

    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(8, 32))
    lab = rng.integers(0, 8, args.n)
    X = (centers[lab] + rng.normal(size=(args.n, 32))).astype(np.float32)

    model = tdt.UMAP(n_neighbors=15, max_iter=200, random_state=0, distributed=True,
                     mesh=mesh, device=dev)
    Z, seconds = timed_fit(model, X)
    sil = tdt.silhouette_score(Z, lab, device=dev)
    print(f"silhouette: {sil:.3f}")
    fit = {"embedding": Z, "labels": lab, "seconds": seconds, "silhouette": sil,
           "knn_acc": tdt.knn_label_accuracy(Z, lab, k=10, device=dev)}
    check_fit(SCRIPT, "UMAP", fit)
    return {"fits": {"UMAP": fit}, "n_devices": len(mesh)}


if __name__ == "__main__":
    main()
