"""The run, with its look for a card skipped, on the CPU at a small size: a
sound run comes out correct, and each fault planted in the timed path comes
out not correct, judged by the cells' own limits. One-chip cells exchange
nothing between chips, so that fault has no place here."""

import pytest

from perfbench.cells import Cell
from perfbench.faults import names, planted
from perfbench.run import run_cell

SMALL = {
    "umap.mnist70k": ({"max_iter": 40}, {"n": 600}),
    "tsne.mnist70k": ({"max_iter": 1000}, {"n": 500}),
}
SEED = 2**31 + 11


def _run(name):
    params, data = SMALL[name]
    result, fits = run_cell(Cell(name), SEED, 0.1, False, device="cpu",
                            params_override=params, data_override=data)
    assert fits and result["attempted"] == len(fits)
    return result


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [(name, fault) for name in sorted(SMALL)
                                        for fault in names(Cell(name).config["estimator"])])
def test_a_fault_is_not_correct(name, fault):
    with planted(fault, Cell(name).config["estimator"]):
        result = _run(name)
    assert not result["correct"], result["checks"]


def test_a_hook_the_program_stops_calling_is_named_and_not_correct(monkeypatch, capsys):
    from torchdr_tpu_torch import TSNE

    cell = Cell("tsne.mnist70k")
    est = cell.estimator()
    build = est.build

    def unwatched(params, seed, device, watch):
        model = build(params, seed, device, watch)
        type(model)._loss_gradients = TSNE._loss_gradients  # the per-step hook is never reached
        return model

    monkeypatch.setattr(est, "build", unwatched)
    monkeypatch.setattr(Cell, "estimator", lambda self: est)
    result, _ = run_cell(cell, SEED, 0.1, False, device="cpu", params_override={"max_iter": 300},
                         data_override={"n": 200})
    assert not result["correct"]
    assert result["checks"] == {"hooks_missing": {"value": 1.0, "limit": 0.0}}
    assert "hook not reached in the last fit: grad (from TSNE._loss_gradients" in capsys.readouterr().err
