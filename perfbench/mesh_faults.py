"""Faults across a mesh's shards, planted in the timed path underneath the
harness, which ``correct`` has to fail (not run by the benchmark's runs).

- ``shard_left_out``: the last shard's gradient is never gathered on the
  mesh's first device, so its rows' gradient is 0;
- ``exchange_lost``: the fuzzy union's edge exchange delivers no shard the
  transposed edges it is sent.

They have a place only in a cell whose fit runs on more than one shard (a
UMAP cell with ``distributed``), and plant themselves as the faults of
:mod:`perfbench.faults` do. At a cell's own size on its cards::

    python3 -m perfbench.mesh_faults --workload umap.cells1p3m.mesh4 --seeds 1 \\
        --faults shard_left_out,exchange_lost

adds them to :data:`perfbench.faults.FAULTS` (:func:`register`) and runs
:mod:`perfbench.control` with the same arguments.
"""

from __future__ import annotations

import sys
from unittest import mock

from perfbench import control, faults


def shard_left_out(estimator: str):
    from torchdr_tpu_torch.models.neighbor.umap import UMAP

    full = UMAP._sharded_gradients

    def dropped(self, Z, consts, *args, **kw):
        grad, carry = full(self, Z, consts, *args, **kw)
        grad[consts["shards"][-1]["row0"]:] = 0.0
        return grad, carry

    return mock.patch.object(UMAP, "_sharded_gradients", dropped)


def exchange_lost(estimator: str):
    from torchdr_tpu_torch.parallel import sparse

    full = sparse._merge_rows

    def lost(own, received, *args):
        return full(own, tuple(t[:0] for t in received), *args)

    return mock.patch.object(sparse, "_merge_rows", lost)


MESH_FAULTS = {f.__name__: f for f in (shard_left_out, exchange_lost)}


def register() -> None:
    """The mesh's faults in :mod:`perfbench.faults`' registry, UMAP's only."""
    for name, fault in MESH_FAULTS.items():
        faults.FAULTS.setdefault(name, fault)
        faults.ONLY.setdefault(name, "UMAP")


def main(argv=None) -> int:
    register()
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
