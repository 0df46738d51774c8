"""The port's command-line runner (``torchdr_tpu_torch/cli.py``), the
counterpart of ``tests/test_cli.py``, and the mesh it configures.

Three commands run as a user runs them (``python -m torchdr_tpu_torch.cli``
in a fresh process, ~3 s each for torch's import): ``info``, ``run
--virtual-cpu-devices 4`` and ``bench`` without a path, which runs the
port's headline benchmark and must not import JAX. The others call
``main`` in this process.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu_torch.cli import main
from torchdr_tpu_torch.parallel import make_mesh
from torchdr_tpu_torch.parallel.mesh import VIRTUAL_CPU_DEVICES_ENV

ROOT = Path(__file__).resolve().parents[1]


def _cli(*args, importtime=False):
    cmd = [sys.executable] + (["-X", "importtime"] if importtime else [])
    return subprocess.run(
        cmd + ["-m", "torchdr_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=180, cwd=ROOT,
        env={k: v for k, v in os.environ.items() if k != VIRTUAL_CPU_DEVICES_ENV},
    )


def test_info_command_reports_the_devices():
    out = _cli("info")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("torch ") and lines[1].startswith("cuda ")
    assert lines[2].startswith("devices: [")


def test_run_with_virtual_cpu_devices_builds_a_cpu_mesh(tmp_path):
    script = tmp_path / "s.py"
    script.write_text(
        "import os, sys\n"
        "from torchdr_tpu_torch.parallel import make_mesh\n"
        "print('MESH', [str(d) for d in make_mesh().devices])\n"
        "print('ARGV', sys.argv[1:])\n"
        "print('FORCE_CPU', os.environ.get('TORCHDR_TPU_FORCE_CPU'))\n"
    )
    out = _cli("run", "--virtual-cpu-devices", "4", str(script), "x", "--y", "1")
    assert out.returncode == 0, out.stderr
    assert "MESH ['cpu', 'cpu', 'cpu', 'cpu']" in out.stdout
    assert "ARGV ['x', '--y', '1']" in out.stdout
    assert "FORCE_CPU 1" in out.stdout


def test_bench_without_a_path_returns_1_and_never_imports_jax():
    """``bench`` without ``--path`` runs the port's headline benchmark
    (``python -m torchdr_tpu_torch.benchmarks.bench``), never the repository's
    JAX ``bench.py``, and passes it the arguments it does not know: here a
    device that fails its child, so it prints the failure line and exits 1.
    The CLI's process imports no JAX."""
    out = _cli("bench", "--n", "64", "--device", "no-such-device", importtime=True)
    assert out.returncode == 1
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "metric": "knn_1000000x128_k15_ivf_search_seconds", "value": -1.0, "unit": "s",
        "vs_baseline": 0.0}
    assert "[bench] child failed" in out.stderr and "no-such-device" in out.stderr
    imported = re.findall(r"^import time:[^|]*\|[^|]*\|\s*(\S+)", out.stderr, re.M)
    assert "torchdr_tpu_torch.benchmarks" in imported  # runpy runs the module itself
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "torchdr_tpu")]


def test_run_with_n_devices_exports_the_variable_as_the_jax_runner_does(tmp_path, monkeypatch,
                                                                         capsys):
    monkeypatch.delenv("TORCHDR_TPU_N_DEVICES", raising=False)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    script = tmp_path / "s.py"
    script.write_text("import os\nprint('N', os.environ['TORCHDR_TPU_N_DEVICES'])\n")
    assert main(["run", "--n-devices", "2", str(script)]) == 0
    assert "N 2" in capsys.readouterr().out


def test_no_command_shows_help(capsys):
    assert main([]) == 1
    assert "usage" in capsys.readouterr().out.lower()


def test_bench_runs_the_given_path(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    script = tmp_path / "b.py"
    script.write_text("import sys\nif __name__ == '__main__':\n    print('BENCH', sys.argv)\n")
    assert main(["bench", "--path", str(script)]) == 0
    assert f"BENCH ['{script}']" in capsys.readouterr().out
    assert main(["bench", "--path", str(tmp_path / "missing.py")]) == 1
    assert "not found; pass --path" in capsys.readouterr().err


def test_make_mesh_takes_the_virtual_cpu_devices(monkeypatch):
    monkeypatch.setenv(VIRTUAL_CPU_DEVICES_ENV, "3")
    assert [str(d) for d in make_mesh().devices] == ["cpu"] * 3
    assert len(make_mesh(n_devices=2)) == 2
    assert [str(d) for d in make_mesh(devices=["cpu"]).devices] == ["cpu"]


def test_importing_utils_imports_no_matplotlib_and_builds_nothing():
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import torchdr_tpu_torch.utils as u; print('LIB', u.native_loader._lib)"],
        capture_output=True, text=True, timeout=180, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "LIB None" in out.stdout
    imported = re.findall(r"^import time:[^|]*\|[^|]*\|\s*(\S+)", out.stderr, re.M)
    assert "torchdr_tpu_torch.utils.visu" in imported
    assert not [m for m in imported if m.split(".")[0] == "matplotlib"]
