"""An installed port can build its kernels.

A wheel of the repository ships the CUDA sources that ``ops/cuda/build.py``
compiles at first use, the digits record's data and reference, and the
``torch`` extra; where the package directory is not writable (an installed
package), the kernels' libraries and the native loader's go to
``~/.cache/torchdr_tpu_torch/build``. The card's side
of this (a read-only copy builds K1 there and launches it) is
``chip_smoke.py`` phase 14 (b).
"""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu_torch.ops.cuda import build
from torchdr_tpu_torch.utils import native_loader

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "torchdr_tpu_torch"


def test_wheel_ships_the_kernel_sources_and_the_torch_extra(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    shutil.copytree(PACKAGE, src / PACKAGE.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", "-q",
         "-w", str(tmp_path / "dist"), str(src)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    sources = sorted(p.name for p in (PACKAGE / "ops" / "csrc").glob("*.cu"))
    assert sources == sorted(f"{lib}.cu" for lib in build.SIGNATURES)
    for name in sources:
        assert f"torchdr_tpu_torch/ops/csrc/{name}" in names
    for name in ("data/digits.csv.gz", "real_digits_reference.json"):  # the digits record
        assert f"torchdr_tpu_torch/benchmarks/{name}" in names
    (meta,) = [n for n in names if n.endswith(".dist-info/METADATA")]
    metadata = zipfile.ZipFile(wheel).read(meta).decode()
    assert "Provides-Extra: torch" in metadata
    assert 'Requires-Dist: torch; extra == "torch"' in metadata


def test_build_directories_fall_back_to_the_user_cache_where_the_package_is_read_only(
        monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    assert build.build_dir() == PACKAGE / "_build"  # a checkout: writable
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    cache = tmp_path / ".cache" / "torchdr_tpu_torch" / "build"
    assert build.build_dir() == cache
    assert build.library_path("umap_repulsion").parent == cache
    assert native_loader.library_path().parent == cache
