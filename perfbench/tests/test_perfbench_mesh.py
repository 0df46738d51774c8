"""The four-card UMAP cell (``umap.cells1p3m.mesh4``): found by its name with
its configuration, traffic and limits; its four readers, each None where
the run holds nothing of the mesh to read (a program whose step runs on one
card, or without the mesh's spans); and, on a 4-way CPU mesh at a small
size, a sound run correct and each fault across shards of
:mod:`perfbench.mesh_faults` (a shard's gradient not gathered, the
exchange's edges lost) not correct."""

import json
import types
from pathlib import Path

import pytest

from perfbench import faults, mesh_faults
from perfbench.cells import Cell, load_json, load_module
from perfbench.mesh_faults import MESH_FAULTS
from perfbench.roofline import k1

ROOT = Path(__file__).resolve().parents[2]
CELL = "umap.cells1p3m.mesh4"
SPANS = {"mesh_replicate_s": "knn.replicate", "mesh_search_s": "knn.shards",
         "mesh_exchange_s": "affinity.exchange"}


def _reader(name):
    return load_module(ROOT / "perfbench" / "metrics" / f"{name}.py", name)


def test_the_mesh_cell_is_the_one_card_cell_over_four_cards():
    cell, one = Cell(CELL), Cell("umap.cells1p3m")
    assert cell.chips == 4 and one.chips == 1
    assert cell.traffic == one.traffic and cell.limits() == one.limits()
    assert cell.params() == dict(one.params(), distributed=True)
    assert cell.config["params"] == dict(load_json(ROOT / "perfbench/configs/umap.json")["params"],
                                         distributed=True)
    assert cell.config["reduced"] == [] and cell.estimator().judge
    readers = {m["name"] for m, _ in cell.metrics(trace=True)}
    assert set(SPANS) | {"k1_mesh_roofline", "step_ms", "device_idle"} <= readers
    assert not {"k1_roofline", "knn_search_s", "knn_build_s"} & readers
    assert {m["name"] for m, _ in cell.metrics(trace=False)} == {
        m["name"] for m in cell.bench["end_to_end"] if "workloads" not in m}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_mesh_span_reader_reads_its_span_or_none(name):
    key = SPANS[name]
    fits = [{"n_iter": 500, "timings": {key: 0.25}}, {"n_iter": 500, "timings": {key: 0.75}}]
    assert _reader(name).read({"fits": fits}) == pytest.approx(0.5)
    # a program without the span: the parent, or a fit on one card
    fits[1] = {"n_iter": 500, "timings": {"knn.search": 0.5}}
    assert _reader(name).read({"fits": fits}) is None
    assert _reader(name).read({"fits": []}) is None


def _ctx(launches, device_s=0.12, n=1_300_000, chips=4, profile=True):
    prof = {"launches": {"k1": launches}, "shapes": {"n": n, "S": 512, "d": 2},
            "device_s_by_name": {"void (anonymous namespace)::repulsion_kernel<2, false>(...)":
                                 device_s, "elementwise_kernel": 9.0}}
    return {"profile": prof if profile else None, "cell": types.SimpleNamespace(chips=chips),
            "fits": [{"n_iter": 500}, {"n_iter": 500}]}


def test_k1_mesh_roofline_takes_a_shard_s_rows():
    reader = _reader("k1_mesh_roofline")
    assert reader.COUNTERS == {"k1": k1.COUNTER}
    got = reader.read(_ctx(4 * 500))
    bound_ms, _ = k1.bound_ms(1_300_000 / 4, 512, 2)
    assert got == pytest.approx(100.0 * bound_ms / (0.12 * 1e3 / 2000), rel=1e-12)
    # a quarter of the one-card launch's bound, a quarter of its time: the
    # one-card reading, had each card taken a quarter as fast as the one
    assert got == pytest.approx(100.0 * k1.bound_ms(1_300_000, 512, 2)[0] / (0.12 * 1e3 / 500),
                                rel=1e-3)


@pytest.mark.parametrize("ctx", [_ctx(500), _ctx(0), _ctx(2000, profile=False)],
                         ids=["one launch a step", "no launch", "untraced"])
def test_k1_mesh_roofline_is_none_without_a_launch_a_shard(ctx):
    assert _reader("k1_mesh_roofline").read(ctx) is None


def _small_mesh_run(monkeypatch):
    """A run of the cell on a 4-way CPU mesh at 3,000 rows and 40 steps."""
    from perfbench.run import run_cell
    from torchdr_tpu_torch.parallel.mesh import VIRTUAL_CPU_DEVICES_ENV

    monkeypatch.setenv(VIRTUAL_CPU_DEVICES_ENV, "4")
    result, fits = run_cell(Cell(CELL), 2**31 + 11, 0.1, False, device="cpu",
                            params_override={"max_iter": 40}, data_override={"n": 3000})
    assert fits and {"knn.replicate", "knn.shards", "affinity.exchange"} <= set(fits[0]["timings"])
    return result


def test_a_sound_mesh_run_is_correct(monkeypatch):
    result = _small_mesh_run(monkeypatch)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(MESH_FAULTS), ids=["exchange", "shard"])
def test_a_mesh_fault_is_not_correct(monkeypatch, fault):
    for name, plant in MESH_FAULTS.items():  # as ``register`` does, for this test only
        monkeypatch.setitem(faults.FAULTS, name, plant)
        monkeypatch.setitem(faults.ONLY, name, "UMAP")
    assert fault in faults.names("UMAP") and fault not in faults.names("TSNE")
    with faults.planted(fault, "UMAP"):
        result = _small_mesh_run(monkeypatch)
    assert not result["correct"], result["checks"]


def test_the_mesh_faults_register_for_the_control(monkeypatch):
    """``python3 -m perfbench.mesh_faults`` adds its faults for UMAP and
    runs the control with its arguments."""
    monkeypatch.setattr(faults, "FAULTS", dict(faults.FAULTS))
    monkeypatch.setattr(faults, "ONLY", dict(faults.ONLY))
    seen = []
    monkeypatch.setattr(mesh_faults.control, "main", lambda argv: seen.append(argv) or 0)
    assert mesh_faults.main(["--workload", CELL]) == 0 and seen == [["--workload", CELL]]
    assert set(MESH_FAULTS) <= set(faults.names("UMAP"))
    assert not set(MESH_FAULTS) & set(faults.names("TSNE"))
