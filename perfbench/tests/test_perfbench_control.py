"""The control (the reference one precision below the configuration's: TF32
products, bfloat16 elementwise arithmetic) put in the program's place fails
at least one of each cell's limits, where the program at the same fit keeps
all of them. On the CPU at a small size; ``python3 -m perfbench.control``
reads the same at the cells' own sizes on the card."""

import pytest

from perfbench.cells import Cell
from perfbench.control import readings

SMALL = {
    "umap.mnist70k": ({"max_iter": 40}, {"n": 600}),
    "umap.cells1p3m": ({"max_iter": 40}, {"n": 2000}),
    "tsne.mnist70k": ({"max_iter": 1000}, {"n": 500}),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_a_limit(name):
    cell = Cell(name)
    params, data = SMALL[name]
    got = readings(cell, 2**31 + 29, True, "cpu", params, data)
    limits = cell.limits()
    assert set(got["program"]) == set(limits)
    assert all(got["program"][k] <= limits[k] for k in limits), got["program"]
    assert any(got["control"][k] > limits[k] for k in limits), got["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_a_limit_at_the_cells_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = Cell(name)
    got = readings(cell, 4_000_000_099, True, "cuda")
    limits = cell.limits()
    assert all(got["program"][k] <= limits[k] for k in limits), got["program"]
    assert any(got["control"][k] > limits[k] for k in limits), got["control"]
