"""The port's last two repo scripts (``torchdr_tpu_torch/benchmarks/
{real_digits,profile_umap_step}.py``) against the JAX scripts they port,
on the CPU.

- the committed digits are scikit-learn's bundled file, byte for byte, and
  ``load_digits`` returns scikit-learn's arrays bit for bit;
- the torch ``trustworthiness`` is scikit-learn's within 1e-5 at k = 5 and
  15 on three embeddings of the digits;
- the six estimators take the JAX script's arguments (the JAX script run
  with recording stand-ins for its estimators, metrics and scikit-learn's
  t-SNE), and a short run prints the JAX script's keys;
- each part of the step decomposition is the JAX script's function (taken
  from its ``jax.jit`` calls), evaluated in float64 on the same inputs,
  within 1e-5; a short run prints the seven readings.
"""

import hashlib
import importlib.util
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdr_tpu
import torchdr_tpu_torch
from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu_torch.benchmarks import profile_umap_step, real_digits

ROOT = Path(__file__).resolve().parents[1]
KEYS = ["cold_s", "warm_s", "silhouette", "trustworthiness15", "knn_acc10", "preservation15"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(out: str) -> list:
    return [json.loads(line[len("JSON "):]) for line in out.splitlines()
            if line.startswith("JSON ")]


def test_committed_digits_are_scikit_learn_s_file_and_load_bit_for_bit():
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    bundled = Path(sklearn_datasets.__file__).parent / "data" / "digits.csv.gz"
    assert (hashlib.sha256(real_digits.DATA.read_bytes()).hexdigest()
            == hashlib.sha256(bundled.read_bytes()).hexdigest())
    want_X, want_y = sklearn_datasets.load_digits(return_X_y=True)
    X, y = real_digits.load_digits()
    assert X.dtype == want_X.dtype == np.float64 and X.shape == (1797, 64)
    assert y.dtype == want_y.dtype and y.shape == (1797,)
    np.testing.assert_array_equal(X, want_X)
    np.testing.assert_array_equal(y, want_y)


def _embedding(kind, X):
    if kind == "pca":
        Xc = X - X.mean(0)
        return Xc @ np.linalg.svd(Xc, full_matrices=False)[2][:2].T
    if kind == "random":
        return X @ np.random.default_rng(0).normal(size=(X.shape[1], 2))
    return X


@pytest.mark.parametrize("k", [5, 15])
@pytest.mark.parametrize("kind", ["pca", "random", "identity"])
def test_trustworthiness_is_scikit_learn_s(kind, k):
    manifold = pytest.importorskip("sklearn.manifold")
    X, _ = real_digits.load_digits()
    X = X.astype(np.float32)  # as the script gives it
    Z = _embedding(kind, X)
    got = real_digits.trustworthiness(X, Z, k, device="cpu")
    want = manifold.trustworthiness(X, Z, n_neighbors=k)
    assert abs(got - want) <= 1e-5, (got, want)
    if kind == "identity":
        assert got == 1.0


def test_estimators_are_the_jax_script_s(monkeypatch, capsys):
    manifold = pytest.importorskip("sklearn.manifold")
    seen = {"jax": {}, "port": {}}

    def keep(side, name):
        class Keep:
            def __init__(self, **kwargs):
                seen[side][name] = kwargs
                self.n_iter_ = 0

            def fit_transform(self, X):
                return np.zeros((X.shape[0], 2), np.float32)

        Keep.__name__ = name
        return Keep

    names = ["UMAP", "TSNE", "LargeVis", "InfoTSNE", "PACMAP", "SNE"]
    for name in names:
        monkeypatch.setattr(torchdr_tpu, name, keep("jax", name))
        monkeypatch.setattr(torchdr_tpu_torch, name, keep("port", name))
    monkeypatch.setattr(manifold, "TSNE", keep("jax", "sklearn_TSNE"))
    for metric in ("silhouette_score", "knn_label_accuracy", "neighborhood_preservation"):
        monkeypatch.setattr(torchdr_tpu, metric, lambda *a, **k: 0.0)
    script = _jax_script("real_digits")
    monkeypatch.setattr(script, "trustworthiness", lambda *a, **k: 0.0)
    script.main()
    jax_lines = _json_lines(capsys.readouterr().out)

    port = real_digits.estimators(device="cpu")
    assert list(port) == names == [line["model"] for line in jax_lines[1:-1]]
    assert list(seen["port"]) == names
    for name in names:
        assert seen["port"][name] == dict(seen["jax"][name], device="cpu"), name
    assert seen["jax"]["sklearn_TSNE"] == dict(perplexity=30, random_state=0, init="pca")
    assert jax_lines[0] == {"step": "dataset", "name": "sklearn_digits", "n": 1797, "d": 64,
                            "classes": 10}


def test_reference_holds_the_jax_script_s_lines():
    ref = real_digits.reference()
    assert ref["recorded"] == "cpu" and ref["jax"] and ref["sklearn"]
    assert ref["dataset"] == {"name": "sklearn_digits", "n": 1797, "d": 64, "classes": 10}
    assert list(ref["fits"]) == ["UMAP", "TSNE", "LargeVis", "InfoTSNE", "PACMAP", "SNE",
                                 "sklearn_TSNE_cpu"]
    for fit in ref["fits"].values():
        assert set(fit) == set(KEYS[2:])  # quality only: no seconds
    gates = real_digits.gates("UMAP", ref)
    jax_acc = ref["fits"]["UMAP"]["knn_acc10"]
    assert gates["knn_acc10"] == (0.9 if jax_acc >= 0.95 else jax_acc - 0.05)
    assert gates["trustworthiness15"] == ref["fits"]["UMAP"]["trustworthiness15"] - 0.01


def test_short_run_prints_the_jax_script_s_keys_and_finite_readings(capsys):
    # 400 rows: InfoTSNE's 300 negatives exclude each row's ~90 input
    # neighbours, so it refuses 300 rows, in the JAX package too
    out = real_digits.main(["--n", "400", "--max-iter", "10", "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"step": "dataset", "name": "sklearn_digits", "n": 400, "d": 64,
                        "classes": 10}
    assert [line["model"] for line in lines[1:]] == [*out["fits"], "sklearn_TSNE_cpu"]
    for line in lines[1:-1]:
        assert list(line) == ["step", "model", *KEYS]
        assert all(math.isfinite(line[key]) for key in KEYS), line
        fit = out["fits"][line["model"]]
        assert fit["embedding"].shape == (400, 2) and np.isfinite(fit["embedding"]).all()
        assert fit["steps"] <= 10
    sk = lines[-1]
    assert sk["recorded"] == "cpu" and sk["cold_s"] is None and sk["n"] == 1797
    assert all(math.isfinite(sk[key]) for key in KEYS[2:])


N, WIDTH, N_NEG = 500, 24, 15


@pytest.fixture(scope="module")
def jax_parts():
    """The JAX script's seven jitted functions, in its order, taken from its
    ``jax.jit`` calls (each call's result a dummy, so nothing is timed)."""
    script = _jax_script("profile_umap_step")
    parts = []

    def capture(f):
        parts.append(f)
        return lambda *args: jnp.zeros((1, 1))

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", capture)
    mp.setattr(jax.config, "update", lambda *args: None)  # its compile-cache line
    mp.setattr(script, "timeit", lambda fn, reps=20: (fn(), 0.0)[1])
    try:
        script.main()
    finally:
        mp.undo()
    assert len(parts) == 7
    return parts


@pytest.fixture(scope="module")
def step_inputs():
    Z, NN, P, _ = profile_umap_step.inputs(N, WIDTH, "cpu")
    neg = torch.from_numpy(np.random.default_rng(1).integers(0, N, (N, N_NEG)))
    return Z, NN, P, neg


@pytest.mark.parametrize("part", ["trivial", "gather_sum", "sqdist", "attraction",
                                  "attraction_1pow", "repulsion", "pow_only"])
def test_step_part_is_the_jax_script_s_formula(part, jax_parts, step_inputs, monkeypatch,
                                               capsys):
    capsys.readouterr()  # the JAX script's lines
    Z, NN, P, neg = step_inputs
    order = ["trivial", "gather_sum", "sqdist", "attraction", "attraction_1pow", "repulsion",
             "pow_only"]
    fn = jax_parts[order.index(part)]
    with jax.enable_x64(True):
        z, nn, p = (jnp.asarray(t.numpy().astype(np.float64) if t.is_floating_point()
                                else t.numpy()) for t in (Z, NN, P))
        if part == "repulsion":
            monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(neg.numpy()))
            want = fn(z, jax.random.PRNGKey(0))
        elif part == "trivial":
            want = fn(z)
        elif part in ("attraction", "attraction_1pow"):
            want = fn(z, nn, p)
        else:
            want = fn(z, nn)
        want = np.asarray(want)
    assert want.dtype == np.float64
    port = getattr(profile_umap_step, part)
    got = {"trivial": lambda: port(Z), "repulsion": lambda: port(Z, None, N_NEG, neg=neg),
           "attraction": lambda: port(Z, NN, P),
           "attraction_1pow": lambda: port(Z, NN, P)}.get(part, lambda: port(Z, NN))()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_step_decomposition_prints_its_seven_readings(capsys):
    out = profile_umap_step.main(["--n", "2000", "--reps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    labels = ["dispatch overhead", "gather (n,240,2) + sum", "indexed sqdist",
              "attraction full", "attraction 1-pow", "repulsion full", "sqdist+pow only"]
    assert [line.split(":")[0] for line in lines] == labels == list(out["readings"])
    for line in lines:
        assert re.fullmatch(r"[^:]+: -?\d+\.\d{3} ms( \(pow ≈ -?\d+\.\d{3} ms\))?; "
                            r"device not measured", line), line
    for label in ("attraction full", "attraction 1-pow", "repulsion full"):
        assert out["outputs"][label].abs().max() <= 4
    assert all(torch.isfinite(o).all() for o in out["outputs"].values())


def test_step_parts_are_main_s_calls_on_given_negatives(step_inputs):
    Z, NN, P, neg = step_inputs
    parts = profile_umap_step.parts(Z, NN, P, None, neg)
    assert [label for label, _ in parts] == [
        "dispatch overhead", "gather (n,240,2) + sum", "indexed sqdist", "attraction full",
        "attraction 1-pow", "repulsion full", "sqdist+pow only"]
    got = dict(parts)["repulsion full"]()
    want = profile_umap_step.repulsion(Z, None, neg=neg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("jax_acc, gate", [(0.99, 0.9), (0.95, 0.9), (0.9322, 0.9322 - 0.05)])
def test_digits_accuracy_gate_is_the_gallery_s_rule(jax_acc, gate):
    from torchdr_tpu_torch.examples import _common

    assert _common.acc_gate(jax_acc) == gate
    ref = {"fits": {"SNE": {"knn_acc10": jax_acc, "trustworthiness15": 0.959}}}
    assert real_digits.gates("SNE", ref)["knn_acc10"] == gate
