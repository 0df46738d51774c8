"""ctypes binding of the native C++ batch loader (counterpart of
``torchdr_tpu/utils/native_loader.py``).

``native/batch_loader.cpp`` maps a float32 ``.npy`` matrix and serves row
batches through a background prefetch thread, so reading the next batch
overlaps the device's work on this one. At first use the source is
compiled with ``g++`` and ``native/Makefile``'s flags into
``<build>/libtdr_native-<hash>.so`` (``<hash>`` from the source and the
flags, so an edited source is rebuilt), where ``<build>`` is the kernels'
build directory (``ops/cuda/build.build_dir``: the package's ``_build/``
where it is writable, else ``~/.cache/torchdr_tpu_torch/build``); nothing
is written under ``native/``. Where the build or the load fails (an
installed package has no ``native/`` beside it), the loader reads the file
through numpy's memory map instead and logs a warning saying so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .logger import get_logger

_SRC = Path(__file__).resolve().parents[2] / "native" / "batch_loader.cpp"
#: native/Makefile's CXXFLAGS, and -shared
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_lib = None
_logger = get_logger("NpyBatchLoader")


def library_path() -> Path:
    from ..ops.cuda.build import build_dir

    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return build_dir() / f"libtdr_native-{digest[:12]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_SRC)], capture_output=True,
                          timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(proc.stderr.decode(errors="replace")[-2000:])
    os.replace(tmp, out)
    return out


def _load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (with a warning)
    where the build or the load fails."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        _logger.warning(f"native batch loader unavailable ({err}); reading through numpy.")
        return None
    lib.tdr_loader_open.restype = ctypes.c_void_p
    lib.tdr_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    for fn in ("tdr_loader_rows", "tdr_loader_cols", "tdr_loader_n_batches",
               "tdr_loader_batch_rows"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.tdr_loader_get.restype = ctypes.c_int64
    lib.tdr_loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
    ]
    lib.tdr_loader_close.restype = None
    lib.tdr_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_library() is not None


class NpyBatchLoader:
    """Float32 row batches of a 2-D ``.npy`` file, in order.

    ``backend`` is "native" (the C++ prefetching loader) or "numpy" (a
    memory-mapped read): ``force_numpy`` asks for the latter, and a failed
    build of the former falls back to it with a warning. Any function that
    takes a batch feed takes one (``knn_graph_from_batches``,
    ``ivf_build_from_batches``, ``knn_graph_streaming``).
    """

    def __init__(self, path: str, batch_rows: int = 4096, force_numpy: bool = False):
        self.path = str(path)
        self.batch_rows = int(batch_rows)
        self._handle = None
        self._lib = None if force_numpy else _load_library()
        if self._lib is not None:
            self._handle = self._lib.tdr_loader_open(self.path.encode(), self.batch_rows)
            if not self._handle:
                _logger.warning(f"native batch loader cannot open {self.path}; "
                                "reading through numpy.")
                self._lib = None
        if self._lib is not None:
            self.n_rows = self._lib.tdr_loader_rows(self._handle)
            self.n_cols = self._lib.tdr_loader_cols(self._handle)
            self.n_batches = self._lib.tdr_loader_n_batches(self._handle)
        else:
            self._mmap = np.load(self.path, mmap_mode="r")
            if self._mmap.ndim != 2 or self._mmap.dtype != np.float32:
                raise ValueError(
                    "[TorchDR-Torch] NpyBatchLoader requires a 2D float32 .npy file."
                )
            self.n_rows, self.n_cols = self._mmap.shape
            self.n_batches = -(-self.n_rows // self.batch_rows)

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "numpy"

    def __len__(self):
        return self.n_batches

    def get_batch(self, b: int) -> np.ndarray:
        if not 0 <= b < self.n_batches:
            raise IndexError(b)
        if self._lib is not None:
            out = np.empty((self.batch_rows, self.n_cols), np.float32)
            got = self._lib.tdr_loader_get(
                self._handle, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            if got < 0:
                raise RuntimeError(f"[TorchDR-Torch] native loader failed on batch {b}")
            return out[:got]
        start = b * self.batch_rows
        return np.asarray(self._mmap[start : start + self.batch_rows], np.float32)

    def __iter__(self) -> Iterator[np.ndarray]:
        for b in range(self.n_batches):
            yield self.get_batch(b)

    def close(self):
        if self._lib is not None and self._handle:
            self._lib.tdr_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
