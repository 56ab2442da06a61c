"""Build the package's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
``rsba_tpu_torch/_build/<name>-<hash>.so`` at first use and loaded with
``ctypes``.  The hash covers the source and the flags, so an edited
source rebuilds; nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


class Library:
    """A built and loaded kernel library, with its build record."""

    def __init__(self, name: str):
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        self.path = BUILD_DIR / f"{name}-{digest[:16]}.so"
        self.build_seconds = 0.0
        self.build_log = ""
        if not self.path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{self.build_log}")
            os.replace(tmp, self.path)
        self.lib = ctypes.CDLL(str(self.path))


_LIBS: dict[str, Library] = {}


def load(name: str) -> Library:
    """Build (once per source version) and load ``csrc/<name>.cu``."""
    if name not in _LIBS:
        _LIBS[name] = Library(name)
    return _LIBS[name]
