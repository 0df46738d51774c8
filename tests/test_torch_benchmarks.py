"""The port's benchmarks (``torchdr_tpu_torch/benchmarks/{bench,knn_benchmark,
umap_single_cell}.py``) against the JAX scripts they port, on the CPU.

- both kNN benchmark data kinds and the single-cell rows and labels are the
  JAX scripts' arrays, bit for bit (the JAX single-cell script is run with
  its estimator replaced by one that keeps what it is given);
- the exact float32 tier's ids are the JAX package's ``knn_graph``'s; the
  port's other two tiers compute that same graph (ROADMAP, "Deviations");
- the headline bench's child builds, searches and reads recall on the CPU,
  and its parent prints the failure line and exits 1 when the child times
  out;
- the single-cell benchmark prints its line;
- no script imports ``jax``, ``torchdr_tpu`` or ``sklearn``.
"""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdr_tpu
from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.ops.distance import knn_graph as jax_knn_graph
from torchdr_tpu_torch.benchmarks import bench, knn_benchmark, umap_single_cell

ROOT = Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["clustered", "random"])
def test_knn_benchmark_data_is_the_jax_script_s(kind):
    want = _jax_script("knn_benchmark").make_data(700, 16, kind)
    got = knn_benchmark.make_data(700, 16, kind)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_umap_single_cell_data_and_estimator_are_the_jax_script_s(monkeypatch, capsys):
    seen = {}

    class Keep:
        def __init__(self, **kwargs):
            seen["kwargs"] = kwargs

        def fit_transform(self, X):
            seen["X"] = X
            return np.zeros((X.shape[0], 2), np.float32)

    def silhouette(Z, labels):
        seen["labels"] = labels
        return 0.0

    monkeypatch.setattr(torchdr_tpu, "UMAP", Keep)
    monkeypatch.setattr(torchdr_tpu, "silhouette_score", silhouette)
    monkeypatch.setattr(sys, "argv", ["umap_single_cell.py", "--n", "600", "--pca-dims", "12",
                                      "--iters", "7"])
    _jax_script("umap_single_cell").main()
    X, labels = umap_single_cell.make_data(600, 12)
    np.testing.assert_array_equal(X, seen["X"])
    np.testing.assert_array_equal(labels, seen["labels"])  # every row: 600 // 5000 = 0
    assert seen["kwargs"] == dict(n_neighbors=30, max_iter=7, random_state=0, distributed=False)
    assert "UMAP n=600 d=12 iters=7" in capsys.readouterr().out


def test_exact_tier_ids_are_the_jax_package_s_and_every_tier_is_exact():
    X = knn_benchmark.make_data(300, 128, "clustered")
    res = knn_benchmark.run_tiers(torch.from_numpy(X), k=15)
    assert list(res) == ["exact/f32", "exact/bf16", "approx@0.95"]
    _, want = jax_knn_graph(jnp.asarray(X), k=15, block_size=2048, mode="exact",
                            precision="highest")
    np.testing.assert_array_equal(res["exact/f32"]["indices"].numpy(), np.asarray(want))
    for label in ("exact/bf16", "approx@0.95"):
        assert res[label]["recall"] == 1.0
        assert torch.equal(res[label]["indices"], res["exact/f32"]["indices"])


def test_bench_child_builds_searches_and_reads_recall_on_the_cpu():
    # 10,000 rows: 10 a centre. At 4,096 (4 a centre) recall@15 is set by the
    # draw in both packages (0.82-0.92 in the port over four data seeds, the
    # JAX script's own draw 0.8906); at 10,000 the JAX draw reads 0.9337
    out = bench._run_child(n=10_000, nlist=32, device="cpu")
    assert set(out) == {"build_s", "search_s", "recall"}
    assert out["build_s"] > 0 and out["search_s"] > 0
    assert out["recall"] >= 0.9


def test_bench_prints_the_failure_line_and_exits_1_when_the_child_times_out(monkeypatch, capsys):
    """The parent's other failure path (a child that fails is
    ``tests/test_torch_cli.py::test_bench_without_a_path_returns_1_and_never_imports_jax``)."""
    def timeout(cmd, **kwargs):
        assert cmd[1:5] == ["-m", "torchdr_tpu_torch.benchmarks.bench", "--child", "--n"]
        raise subprocess.TimeoutExpired(cmd, kwargs["timeout"])

    monkeypatch.setattr(bench.subprocess, "run", timeout)
    assert bench.main(["--n", "64", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == {
        "metric": "knn_1000000x128_k15_ivf_search_seconds", "value": -1.0, "unit": "s",
        "vs_baseline": 0.0}
    assert "[bench] child timed out" in err


def test_umap_single_cell_prints_its_line(capsys):
    out = umap_single_cell.main(["--n", "600", "--iters", "20", "--device", "cpu"])
    assert re.fullmatch(r"UMAP n=600 d=50 iters=20: \d+\.\ds silhouette=-?\d\.\d{3}\n",
                        capsys.readouterr().out)
    assert out["embedding"].shape == (600, 2) and np.isfinite(out["embedding"]).all()
    assert out["silhouette"] > 0.5  # 40 centres at scale 5, far apart in 50-D


def test_no_port_script_imports_jax_the_jax_package_or_sklearn():
    """The five benchmark scripts and the API-docs generator (executed as a
    module, not run) in a fresh process, which prints its ``sys.modules``."""
    code = (
        "import importlib, importlib.util, json, sys\n"
        "for m in ('bench', 'knn_benchmark', 'umap_single_cell', 'real_digits',\n"
        "          'profile_umap_step'):\n"
        "    importlib.import_module('torchdr_tpu_torch.benchmarks.' + m)\n"
        "spec = importlib.util.spec_from_file_location('gen', 'scripts/gen_torch_api_docs.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    for m in ("umap_single_cell", "real_digits", "profile_umap_step"):
        assert f"torchdr_tpu_torch.benchmarks.{m}" in loaded
    for banned in ("jax", "jaxlib", "torchdr_tpu", "sklearn"):
        assert not [m for m in loaded if m.split(".")[0] == banned], banned
