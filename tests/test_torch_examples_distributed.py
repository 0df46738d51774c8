"""The gallery's distributed and single-cell scripts on the CPU, in-process
on one torch thread, each on a mesh of 8 CPU devices where it takes one:
each passes its own gates (``examples/_common.py``).

``distributed_umap`` runs at the runner's ``--fast`` size (1,024 rows). The
other three run below it: on the CPU the fits take the kernels' plain
versions (float64, unfused), and at the runner's sizes (3,000 rows of
``single_cell``, the 20,000 and 10,000 rows the two benchmarks always take)
each takes minutes on one thread. The tests take 500, 1,000 and 1,000 rows
(``--n``); the card runs every script at its full size
(``chip_smoke.py --examples``).
"""

import pytest

from _examples_run import check_gates, run
from _torch_threads import worker_threads  # noqa: F401


@pytest.mark.parametrize("script,argv", [
    ("distributed/distributed_umap", ("--n", "1024")),
    ("distributed/knn_accuracy_benchmark", ("--n", "1000")),
    ("distributed/neighborhood_preservation_benchmark", ("--n", "1000")),
    ("single_cell/single_cell", ("--n", "500")),
])
def test_script_passes_its_gates(script, argv):
    out = run(script, *argv)
    check_gates(out)
    assert out.get("n_devices", 8) == 8
