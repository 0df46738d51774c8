"""The readers of the program's spans (``perfbench/metrics/``, through
``perfbench/spans.py``) on a synthetic record of two fits: each value as its
docstring defines it, in the unit ``BENCHMARK.json`` gives it, and None where
a fit lacks a span it reads (a program without the spans)."""

import json
from pathlib import Path

import pytest

from perfbench.cells import load_module

ROOT = Path(__file__).resolve().parents[2]


def _fit(scale, n_iter):
    t = {"fit": 10.0, "api.check": 0.5, "api.dedup": 2.0, "api.h2d": 0.25, "api.d2h": 0.125,
         "affinity": 3.0, "knn": 2.5, "knn.build": 1.5, "knn.search": 0.75, "init": 0.25,
         "optimize": 3.5, "optimize.consts": 0.5, "optimize.loop": 2.75, "optimize.wait": 0.75}
    return {"wall_s": 10.5 * scale, "n_iter": n_iter,
            "timings": {k: v * scale for k, v in t.items()}}


FITS = [_fit(1.0, 500), _fit(3.0, 500)]  # means: twice the first fit's

#: metric -> (value, the spans it reads)
WANT = {
    "api_check_s": (1.0, ["api.check"]),
    "api_dedup_s": (4.0, ["api.dedup"]),
    "api_copy_s": (0.75, ["api.h2d", "api.d2h"]),
    "api_rest_s": (20.0 - 2 * (0.5 + 2.0 + 0.25 + 0.125 + 3.0 + 0.25 + 3.5),
                   ["fit", "affinity", "init", "optimize"]),
    "knn_build_s": (3.0, ["knn.build"]),
    "knn_search_s": (1.5, ["knn.search"]),
    "consts_s": (1.0, ["optimize.consts"]),
    "step_issue_ms": (2 * (2.75 - 0.75) / 500 * 1e3, ["optimize.loop", "optimize.wait"]),
    "step_wait_ms": (2 * 0.75 / 500 * 1e3, ["optimize.wait"]),
}
UNITS = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}


def _reader(name):
    return load_module(ROOT / "perfbench" / "metrics" / f"{name}.py", name)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_span_reader_reads_its_spans(name):
    value, keys = WANT[name]
    entry = UNITS[name]
    assert entry["unit"] == ("ms" if name.endswith("_ms") else "s")
    assert entry["source"] == "program_span" and entry["moves"] == "fit_s"
    reader = _reader(name)
    assert reader.read({"fits": FITS}) == pytest.approx(value, rel=1e-12)
    for key in keys:
        fits = [dict(f, timings={k: v for k, v in f["timings"].items() if k != key})
                for f in FITS]
        fits[0] = FITS[0]  # one fit without the span is enough
        assert reader.read({"fits": fits}) is None, key
    assert reader.read({"fits": []}) is None


def test_api_rest_subtracts_whatever_api_spans_there_are():
    fit = _fit(1.0, 500)
    del fit["timings"]["api.dedup"]
    assert _reader("api_rest_s").read({"fits": [fit]}) == pytest.approx(
        10.0 - (0.5 + 0.25 + 0.125 + 3.0 + 0.25 + 3.5))


def test_the_knn_parts_are_read_in_the_ivf_cell_alone():
    assert UNITS["knn_build_s"]["workloads"] == UNITS["knn_search_s"]["workloads"] == [
        "umap.cells1p3m"]
    assert all("workloads" not in UNITS[n] for n in WANT if not n.startswith("knn_"))
