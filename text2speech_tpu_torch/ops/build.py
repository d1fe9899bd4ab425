"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (shared device helpers
are in ``csrc/*.cuh``, included by path) and is compiled at first use into
``build/t2s_torch/lib<name>.so`` under the checkout root, for ``sm_90a``
(Hopper).  Nothing is compiled when a module is imported, and
nothing falls back: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "t2s_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


class CudaLibrary:
    """One compiled ``csrc/<name>.cu``: builds on first :meth:`get`, then
    holds the loaded ``ctypes.CDLL``.  ``build_seconds`` and ``build_log``
    (nvcc's output, including ``-Xptxas -v`` register/shared-memory
    counts) record the last build."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.path = BUILD_DIR / f"lib{name}.so"
        self.signatures = signatures
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib = None

    def build(self) -> Path:
        """Compile the source (always) into :attr:`path`; returns it."""
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True, check=False)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source} (rc {proc.returncode}):\n"
                    f"{self.build_log}")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        return self.path

    def get(self) -> ctypes.CDLL:
        """The loaded library, built first when the ``.so`` is missing or
        older than its source or a shared header (``csrc/*.cuh``)."""
        if self._lib is None:
            newest = max(f.stat().st_mtime
                         for f in (self.source, *CSRC_DIR.glob("*.cuh")))
            stale = (not self.path.exists()
                     or self.path.stat().st_mtime < newest)
            if stale:
                self.build()
            lib = ctypes.CDLL(str(self.path))
            for fn, argtypes in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib
