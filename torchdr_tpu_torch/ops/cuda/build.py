"""Build the CUDA sources of ``ops/csrc/`` and load them with ``ctypes``.

Each source ``ops/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own, at first use, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC

into ``<build>/lib<name>-<hash>.so``, where ``<hash>`` is taken from the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded, also from a cache that several installs share. ``<build>``
(:func:`build_dir`) is the package's ``_build/`` where the package is
writable (a checkout), else ``~/.cache/torchdr_tpu_torch/build`` (an
installed, read-only package). Nothing is compiled when a module is
imported. :func:`build_libraries` starts one ``nvcc`` per source at once.
A library may export several entry points (``SIGNATURES``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "ops" / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

#: each library's entry points: {function: argtypes}
_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GATHER = [_V, _V, _V, _I, _I, _I, _I, _V]  # Zb, idx, out, nb, r, d, c, stream
SIGNATURES = {
    "umap_repulsion": {
        # Z, neg_ids, w, out, row0, rows, d, S, s_tile, lanes, a, b, eps, stream
        "umap_shared_repulsion": [_V, _V, _V, _V, *[_I] * 6, _F, _F, _F, _V],
    },
    "rowlse_fwd": {
        # Z, out, part, n, d, n_chunks, chunk, gaussian, diag, symmetric, stream
        "rowlse_fwd": [_V, _V, _V, *[_I] * 7, _V],
        # Zq, Zdb, out, part, m, n_cols, row_off, d, n_chunks, chunk, gaussian, diag,
        # shared, stream
        "rowlse_fwd_general": [_V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I, _I, _I, _V],
    },
    "rowlse_bwd": {
        # Z, lse, g, out, part, n, d, n_chunks, chunk, gaussian, symmetric, stream
        "rowlse_bwd": [_V, _V, _V, _V, _V, *[_I] * 6, _V],
        # Zq, Zdb, lse, g, dzq, dzdb, part, m, n_cols, row_off, d, n_chunks,
        # chunk, gaussian, kernels launched (int*), stream
        "rowlse_bwd_general": [_V, _V, _V, _V, _V, _V, _V, *[_I] * 7,
                               ctypes.POINTER(ctypes.c_int), _V],
    },
    "bucket_gather": {
        "bucket_take": _GATHER,
        "bucket_onehot": _GATHER,
        "bucket_2level": [*_GATHER[:-1], _I, _V],  # ..., c, grp, stream
    },
    "row_hash": {
        "row_hash": [_V, _V, _I, _I, _V],  # X, out, n, m, stream
    },
    "tsne_attraction": {
        # Z, nn, P, in_ptr, in_src, in_P, grad, loss, n, k, d, gaussian, stream
        "tsne_attraction": [*[_V] * 8, *[_I] * 4, _V],
    },
}

_LOADED: Dict[str, object] = {}  # function -> the bound entry point


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "[TorchDR-Torch] ERROR : nvcc not found; the CUDA kernels are "
            "built from source at first use and need the CUDA toolkit."
        )
    return path


def build_dir() -> Path:
    """Where built libraries go: the package's ``_build/`` when it is (or can
    be made) writable, else ``~/.cache/torchdr_tpu_torch/build``, after the
    JAX package's ``~/.cache/torchdr_tpu/``. The native loader's library goes
    there too."""
    local = _PKG_DIR / "_build"
    if os.access(local if local.is_dir() else _PKG_DIR, os.W_OK):
        return local
    return Path.home() / ".cache" / "torchdr_tpu_torch" / "build"


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def build_libraries(names: Iterable[str] = tuple(SIGNATURES)) -> List[Path]:
    """Compile every missing library, one ``nvcc`` per source, in parallel."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("[TorchDR-Torch] ERROR : nvcc failed for " + "\n".join(failed))
    return [library_path(name) for name in names]


def load_function(name: str, entry: str | None = None):
    """Entry point ``entry`` (by default the only one) of library ``name``,
    built first if needed."""
    if entry is None:
        (entry,) = SIGNATURES[name]
    fn = _LOADED.get(entry)
    if fn is None:
        (path,) = build_libraries([name])
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = SIGNATURES[name][entry]
        fn.restype = ctypes.c_int
        _LOADED[entry] = fn
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(fn, Z, *args):
    """Call the library's entry point on Z's device and its current stream."""
    stream = torch.cuda.current_stream(Z.device).cuda_stream
    if torch.cuda.current_device() == Z.device.index:
        return fn(*args, stream)
    with torch.cuda.device(Z.device):
        return fn(*args, stream)
