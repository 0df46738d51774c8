"""The port's API reference (``scripts/gen_torch_api_docs.py``): an entry for
every public name of the nine subpackages, and the committed
``docs/torch_api.md`` and ``docs/torch_api/`` equal to what the generator
writes now (rerun it after changing a public signature or docstring)."""

import importlib
import importlib.util
import inspect
from pathlib import Path

from _torch_threads import worker_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", ".ops", ".utils", ".parallel", ".eval", ".affinity", ".models",
               ".models.neighbor", ".models.spectral"]


def _generate(out: Path) -> None:
    spec = importlib.util.spec_from_file_location("gen_torch_api_docs",
                                                  ROOT / "scripts" / "gen_torch_api_docs.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.main(["--out", str(out)]) == 0


def _public(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items() if not n.startswith("_") and not inspect.ismodule(v)]


def test_every_public_name_has_an_entry_and_the_committed_docs_are_current(tmp_path):
    _generate(tmp_path)
    pages = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*.md"))
    assert pages == sorted(p.relative_to(ROOT / "docs") for p in
                           [ROOT / "docs" / "torch_api.md", *(ROOT / "docs" / "torch_api").glob("*.md")])
    for page in pages:
        assert (tmp_path / page).read_text() == (ROOT / "docs" / page).read_text(), page
    headings = {line[4:] for page in pages for line in (tmp_path / page).read_text().splitlines()
                if line.startswith("### ")}
    top = importlib.import_module("torchdr_tpu_torch")
    for sub in SUBPACKAGES:
        mod = importlib.import_module("torchdr_tpu_torch" + sub)
        for name in _public(mod):
            exported = name in top.__all__ and getattr(top, name) is getattr(mod, name)
            assert (name if exported else f"{sub[1:]}.{name}") in headings, (sub, name)
