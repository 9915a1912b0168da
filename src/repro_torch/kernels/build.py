"""Build a kernel's CUDA source into a shared library at first use.

Each kernel is a plain C interface compiled by ``nvcc`` into a shared
library and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library goes to ``build/kernels/`` at the repository root,
named by a hash of the source and the compiler flags, so an edited source
builds anew and an unchanged one is loaded as it is.  A failed build raises
with ``nvcc``'s output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-lineinfo", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base:
            cand = pathlib.Path(base) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built on this host")
    return found


def library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def load(source) -> tuple:
    """Build ``source`` (if its library is not there yet) and load it.

    Returns ``(ctypes.CDLL, nvcc_output)``; ``nvcc_output`` holds ptxas's
    register and shared-memory report of a build made in this call ("" when
    the library was already built).  Callers cache the result."""
    source = pathlib.Path(source)
    lib_path = library_path(source)
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a unique name, then rename: concurrent builds of
        # the same source never see a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                   str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {source.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        log = proc.stdout + proc.stderr
    return ctypes.CDLL(str(lib_path)), log
