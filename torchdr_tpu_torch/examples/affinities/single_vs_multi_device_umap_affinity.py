"""UMAP affinity: single-device vs mesh-sharded construction agree exactly
(counterpart of ``examples/affinities/single_vs_multi_device_umap_affinity.py``).

The mesh: every card when the machine has several, else four shards of the
one card; on the CPU (``--device cpu``), ``VIRTUAL_CPU_DEVICES_ENV`` CPU
devices, 8 when unset.

Run: python -m torchdr_tpu_torch.examples.affinities.single_vs_multi_device_umap_affinity [--device cpu]

Gate: the two affinities equal: each row's indices as sets, the values of
each index within ``TOL``.
"""

import numpy as np
import torch

from torchdr_tpu_torch.base import resolve_device
from torchdr_tpu_torch.examples._common import example_mesh, parser
from torchdr_tpu_torch.ops.distance import knn_graph
from torchdr_tpu_torch.ops.sparse import sparse_to_dense, symmetrize_sparse
from torchdr_tpu_torch.parallel import distributed_symmetrize_sparse, knn_graph_ring

SCRIPT = "affinities/single_vs_multi_device_umap_affinity"
TOL = 1e-6


def _rows(values, indices):
    """Each row's {index: value} of a padded sparse matrix, on the host."""
    v, j = values.cpu().numpy(), indices.cpu().numpy()
    return [dict(zip(jr[jr >= 0].tolist(), vr[jr >= 0].tolist())) for vr, jr in zip(v, j)]


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    mesh = example_mesh(args.device)
    n_dev = len(mesh)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32)).to(device)

    # single-device kNN + symmetrization
    d1, i1 = knn_graph(X, k=15)
    v1, j1 = symmetrize_sparse(torch.exp(-d1), i1, mode="sum_minus_prod")

    # mesh: ring kNN (each shard's rows passed round the ring) + the
    # edge-bucket exchange of the symmetrization
    d2, i2 = knn_graph_ring(X, 15, mesh)
    v2, j2 = distributed_symmetrize_sparse(torch.exp(-d2), i2, mesh, mode="sum_minus_prod")

    D1 = sparse_to_dense(v1, j1, 512).cpu().numpy()
    D2 = sparse_to_dense(v2.to(device), j2.to(device), 512).cpu().numpy()
    max_diff = float(np.abs(D1 - D2).max())
    print(f"devices: {n_dev}; fuzzy-union max |single - mesh| = {max_diff:.2e}")

    single, sharded = _rows(v1, j1), _rows(v2, j2)
    same_sets = all(a.keys() == b.keys() for a, b in zip(single, sharded))
    value_err = max((abs(a[c] - b[c]) for a, b in zip(single, sharded) if a.keys() == b.keys()
                     for c in a), default=0.0)
    if not (same_sets and value_err <= TOL and np.all(np.isfinite(D1))):
        raise AssertionError(f"{SCRIPT}: the mesh's affinity differs (index sets equal: "
                             f"{same_sets}, values {value_err:.3e})")
    return {"n_devices": n_dev, "max_abs_diff": max_diff, "value_err": value_err,
            "dense_single": D1, "dense_mesh": D2}


if __name__ == "__main__":
    main()
