"""Nothing the harness or the reference runs loads JAX or the JAX package,
and the reference loads nothing of the program. Top-level module names are
compared whole: ``torchdr_tpu_torch`` is not ``torchdr_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = sorted((ROOT / "perfbench" / "reference").glob("*.py"))


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    names = ["perfbench.run", "perfbench.control", "perfbench.trace", "perfbench.cells",
             "perfbench.watch", "perfbench.faults", "perfbench.hostnoise", "perfbench.estimators.UMAP", "perfbench.estimators.TSNE"]
    names += [f"perfbench.reference.{p.stem}" for p in REFERENCE if p.stem != "__init__"]
    loaded = _modules_after("import torchdr_tpu_torch\n" + "\n".join(f"import {m}" for m in names))
    assert "torchdr_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = [f"perfbench.reference.{p.stem}" for p in REFERENCE if p.stem != "__init__"]
    loaded = _modules_after("\n".join(f"import {m}" for m in names))
    assert not loaded & {"torchdr_tpu_torch", *FORBIDDEN}
    for path in REFERENCE:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & {"torchdr_tpu_torch", *FORBIDDEN}, (path.name, tops)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchdr_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "torchdr_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert forbidden_modules() == ["jax", "torchdr_tpu"]
