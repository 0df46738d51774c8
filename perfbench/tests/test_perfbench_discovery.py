"""A new cell, configuration, traffic mix, generator and metric are found by
their names in ``BENCHMARK.json``, with no edit to a file that is there."""

import json
import shutil
from pathlib import Path

import numpy as np

from perfbench.cells import Cell

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}

    pb = tmp_path / "perfbench"
    (pb / "configs" / "umap3d.json").write_text(json.dumps(
        {"estimator": "UMAP", "source": "x", "params": {"n_components": 3},
         "assumed": [], "reduced": []}))
    (pb / "traffic" / "ramp.json").write_text(json.dumps(
        {"generator": "ramp", "params": {"n": 40, "d": 3}}))
    (pb / "data" / "ramp.py").write_text(
        "import numpy as np\n\ndef make(params, seed):\n"
        "    return np.arange(params['n'] * params['d'], dtype=np.float32)"
        ".reshape(params['n'], params['d']) + seed\n")
    (pb / "workloads" / "umap3d.ramp.json").write_text(json.dumps(
        {"from_source": {"max_iter": 7}, "for_the_port": {}, "limits": {"step_gap": 0.5}}))
    (pb / "metrics" / "fits_n.py").write_text("def read(ctx):\n    return len(ctx['fits'])\n")
    bench["configs"].append({"name": "umap3d", "source": "x", "file": "perfbench/configs/umap3d.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "umap3d.ramp", "config": "umap3d", "traffic": "ramp",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "fits_n", "unit": "fits", "better": "higher",
                               "source": "host_clock", "layer": "User API", "moves": "fit_s",
                               "workloads": ["umap3d.ramp"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = Cell("umap3d.ramp", root=tmp_path)
    assert cell.config["estimator"] == "UMAP"
    assert cell.params()["n_components"] == 3 and cell.params()["max_iter"] == 7
    assert cell.limits() == {"step_gap": 0.5}
    assert np.array_equal(cell.data(2)[1], np.array([5, 6, 7], dtype=np.float32))
    assert hasattr(cell.estimator(), "judge")
    readers = {m["name"]: r for m, r in cell.metrics(trace=True)}
    assert readers["fits_n"].read({"fits": [1, 2]}) == 2
    assert "k2_roofline" not in readers and "step_ms" in readers
    assert {m["name"] for m, _ in cell.metrics(trace=False)} == {
        m["name"] for m in bench["end_to_end"] if "workloads" not in m}
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data
