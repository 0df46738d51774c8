"""The port's examples gallery (``torchdr_tpu_torch/examples/``) on the CPU.

Each script runs in-process through its ``main(["--device", "cpu", ...])``
on one torch thread, and raises when its own gate fails
(``examples/_common.py``). This file holds the checks against the JAX
package and the runner; ``test_torch_examples_fits.py`` and
``test_torch_examples_distributed.py`` run the other scripts, so that the
suite's workers share them. Here:

- ``_data.py`` equals scikit-learn's generators bit for bit;
- ``jax_reference.json``, which the card's runs of scripts 3, 4, 5 and 8
  are held to, holds what the JAX package computes now (scripts 4, 5 and 8
  here; ``tests/_examples_reference.py`` writes the file), and the accuracy
  gates follow its JAX readings (0.9, or a reading below 0.95 less 0.05);
- script 9's two affinities equal each other and the JAX package's on the
  same rows (8-device meshes in both);
- script 1: the port's quality numbers within 0.05 of the JAX package's on
  the same data;
- no script imports ``jax``, ``torchdr_tpu`` or ``sklearn``;
- the runner runs a script in a fresh process and exits 1 on a failure.
"""

import importlib
import json
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from _examples_run import run
from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu_torch.examples import _common, _data
from torchdr_tpu_torch.examples.__main__ import find_examples, module_name
from torchdr_tpu_torch.examples.__main__ import main as run_examples

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = json.loads(_common.REFERENCE.read_text())
QUALITY_TOL = 0.05


def _ref_gen():
    import runpy

    return runpy.run_path(str(ROOT / "tests" / "_examples_reference.py"), run_name="ref")


@pytest.mark.parametrize("n,noise,seed", [(500, 0.05, 0), (101, None, 3), (2, 0.3, 7)])
def test_make_moons_is_sklearn_s(n, noise, seed):
    from sklearn.datasets import make_moons

    X, y = _data.make_moons(n_samples=n, noise=noise, random_state=seed)
    want_X, want_y = make_moons(n_samples=n, noise=noise, random_state=seed)
    assert np.array_equal(X, want_X) and np.array_equal(y, want_y) and y.dtype == want_y.dtype


@pytest.mark.parametrize("n,noise,seed", [(1000, 0.05, 0), (37, 0.0, 5)])
def test_make_swiss_roll_is_sklearn_s(n, noise, seed):
    from sklearn.datasets import make_swiss_roll

    X, t = _data.make_swiss_roll(n_samples=n, noise=noise, random_state=seed)
    want_X, want_t = make_swiss_roll(n_samples=n, noise=noise, random_state=seed)
    assert np.array_equal(X, want_X) and np.array_equal(t, want_t)


def test_gallery_mirrors_the_jax_package_s():
    """Every JAX script has its port under the same folder and name, but
    images/cifar10.py (its images and weights are not in the repository)."""
    jax_scripts = sorted(str(p.relative_to(ROOT / "examples")) for p in
                         (ROOT / "examples").rglob("*.py"))
    assert find_examples() == [s for s in jax_scripts if s != "images/cifar10.py"]
    assert set(REFERENCE) == {s[:-3] for s in find_examples()} - {
        "affinities/single_vs_multi_device_umap_affinity"}


def test_accuracy_gates_follow_the_jax_readings():
    """The gate of each labelled fit: 0.9, or the JAX script's reading at
    that size less 0.05 where the reading is below 0.95. At the runner's
    --fast sizes every JAX fit reads at least 0.95."""
    fast = {(script, name): fit["knn_acc"] for script, entry in REFERENCE.items()
            for name, fit in entry.get("fits", {}).items()}
    assert len(fast) == 20 and min(fast.values()) >= 0.95, fast
    for (script, name), acc in fast.items():
        assert _common.accuracy_gate(script, name, 123) == _common.MIN_ACC
    full = REFERENCE["single_cell/single_cell"]["full_size"]
    assert full["n"] == 44_808
    for name, fit in full["fits"].items():
        gate = _common.accuracy_gate("single_cell/single_cell", name, full["n"])
        assert gate == (_common.MIN_ACC if fit["knn_acc"] >= 0.95 else fit["knn_acc"] - 0.05)


@pytest.mark.parametrize("script", ["basics/demo_pca_via_affinity_matcher",
                                    "basics/incremental_pca", "affinities/demo_ea_adaptivity"])
def test_reference_file_is_the_jax_package_s(script):
    """The JAX package computes today what the file holds, to float32's
    last bits."""
    got = _ref_gen()["SCRIPTS"][script]()

    def flat(d):
        return np.concatenate([np.ravel(np.asarray(v, np.float64)) if not isinstance(v, dict)
                               else flat(v) for _, v in sorted(d.items())])

    np.testing.assert_allclose(flat(got), flat(REFERENCE[script]), rtol=1e-6, atol=0)


def test_mesh_affinity_equals_the_single_device_one_and_the_jax_package_s():
    from torchdr_tpu.ops.distance import knn_graph as jax_knn_graph
    from torchdr_tpu.ops.sparse import sparse_to_dense as jax_sparse_to_dense
    from torchdr_tpu.ops.sparse import symmetrize_sparse as jax_symmetrize_sparse
    from torchdr_tpu.parallel import distributed_symmetrize_sparse as jax_dsym
    from torchdr_tpu.parallel import knn_graph_ring as jax_knn_graph_ring
    from torchdr_tpu.parallel import make_mesh as jax_make_mesh

    out = run("affinities/single_vs_multi_device_umap_affinity")
    assert out["n_devices"] == 8 and out["max_abs_diff"] <= 1e-6 and out["value_err"] <= 1e-6
    X = np.random.default_rng(0).normal(size=(512, 16)).astype(np.float32)
    d1, i1 = jax_knn_graph(X, k=15)
    v1, j1 = jax_symmetrize_sparse(np.exp(-d1), i1, mode="sum_minus_prod")
    d2, i2 = jax_knn_graph_ring(X, 15, jax_make_mesh(len(jax.devices())))
    v2, j2 = jax_dsym(np.exp(-d2), i2, jax_make_mesh(len(jax.devices())), mode="sum_minus_prod")
    want_single = np.asarray(jax_sparse_to_dense(v1, j1, 512))
    want_mesh = np.asarray(jax_sparse_to_dense(v2, j2, 512))
    np.testing.assert_allclose(out["dense_single"], want_single, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["dense_mesh"], want_mesh, rtol=0, atol=1e-6)
    assert np.array_equal(out["dense_single"] > 0, want_single > 0)


def test_pca_via_affinity_matcher_aligns_as_the_jax_script():
    out = run("basics/demo_pca_via_affinity_matcher")
    want = REFERENCE["basics/demo_pca_via_affinity_matcher"]["alignment"]
    assert abs(out["alignment"] - want) <= 1e-3


def test_incremental_pca_captures_the_jax_package_s_variances():
    out = run("basics/incremental_pca")
    ref = REFERENCE["basics/incremental_pca"]
    for name in ("IncrementalPCA", "ExactIncrementalPCA"):
        got, want = np.asarray(out[name]["explained_variance"]), np.asarray(
            ref[name]["explained_variance"])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        assert out["fits"][name]["embedding"].shape == (20 * 512, 4)
    np.testing.assert_allclose(out["IncrementalPCA"]["explained_variance_ratio"],
                               ref["IncrementalPCA"]["explained_variance_ratio"],
                               rtol=0, atol=1e-5)


def test_entropic_bandwidths_are_the_jax_package_s():
    out = run("affinities/demo_ea_adaptivity")
    want = np.asarray(REFERENCE["affinities/demo_ea_adaptivity"]["eps"])
    np.testing.assert_allclose(out["eps"], want, rtol=1e-4, atol=0)
    assert abs(out["ea_perplexity"].mean() - 30) < 0.5


def test_basic_usage_scores_as_the_jax_package():
    out = run("basics/basic_usage")
    ref = REFERENCE["basics/basic_usage"]["fits"]
    for name, fit in out["fits"].items():
        for score in ("knn_acc", "silhouette", "preservation"):
            assert abs(fit[score] - ref[name][score]) <= QUALITY_TOL, (name, score)


def test_scripts_need_the_card_unless_told_otherwise():
    mod = importlib.import_module(module_name("affinities/demo_ea_adaptivity.py"))
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_example_mesh_on_the_cpu_takes_the_virtual_device_count(monkeypatch):
    from torchdr_tpu_torch.parallel.mesh import VIRTUAL_CPU_DEVICES_ENV

    monkeypatch.delenv(VIRTUAL_CPU_DEVICES_ENV, raising=False)
    assert [str(d) for d in _common.example_mesh("cpu").devices] == ["cpu"] * 8
    monkeypatch.setenv(VIRTUAL_CPU_DEVICES_ENV, "3")
    assert len(_common.example_mesh("cpu")) == 3


def test_no_script_imports_jax_the_jax_package_or_sklearn():
    """Every script, its helpers and the runner, imported in a fresh process:
    ``-X importtime`` lists each module the process imports, and the
    process prints its ``sys.modules`` at the end."""
    mods = [module_name(s) for s in find_examples()] + [
        "torchdr_tpu_torch.examples.__main__", "torchdr_tpu_torch.examples._data"]
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-c", "import importlib, json, sys; "
         "[importlib.import_module(m) for m in sys.argv[1:]]; print(json.dumps(sorted(sys.modules)))",
         *mods],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert set(mods) <= loaded
    imported = set(re.findall(r"^import time:[^|]*\|[^|]*\|\s*(\S+)", proc.stderr, re.M))
    assert "torchdr_tpu_torch.examples._common" in imported
    for banned in ("jax", "jaxlib", "torchdr_tpu", "sklearn"):
        assert not [m for m in imported | loaded if m.split(".")[0] == banned], banned


def test_runner_runs_a_script_in_a_fresh_process(capsys):
    assert run_examples(["--match", "demo_ea_adaptivity", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[examples] affinities/demo_ea_adaptivity.py: ok in" in out
    assert out.strip().endswith("[examples] 1/1 passed")


def test_runner_exits_1_when_a_script_fails(capsys):
    assert run_examples(["--match", "demo_ea_adaptivity", "--device", "cuda:99"]) == 1
    out = capsys.readouterr().out
    assert "FAIL(1)" in out and "[examples] failed: affinities/demo_ea_adaptivity.py" in out
