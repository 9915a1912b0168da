"""Build a kernel's CUDA source into a shared library at first use.

Each kernel is a plain C interface compiled by ``nvcc`` into a shared
library and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library goes to ``build/kernels/`` at the repository root,
named by a hash of the source and the compiler flags, so an edited source
builds anew and an unchanged one is loaded as it is.  ``nvcc``'s output
(ptxas's register and spill report) is kept beside the library, so a
cached library comes with the report of its build.  A failed build raises
with ``nvcc``'s output; nothing falls back.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

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
    """Build ``source`` (if its library and build report are not there
    yet) and load it.

    Returns ``(ctypes.CDLL, nvcc_output)``; ``nvcc_output`` holds ptxas's
    register, spill and shared-memory report of the library's build, made
    in this call or read from beside the library.  Callers cache the
    result."""
    source = pathlib.Path(source)
    lib_path = library_path(source)
    log_path = lib_path.with_suffix(".log")
    if not (lib_path.exists() and log_path.exists()):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under unique names, then rename: concurrent builds of the
        # same source never see a half-written library or report, and the
        # report is in place before the library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        tmp_log = tmp + ".log"
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                   str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {source.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            pathlib.Path(tmp_log).write_text(proc.stdout + proc.stderr)
            os.replace(tmp_log, log_path)
            os.replace(tmp, lib_path)
        finally:
            for leftover in (tmp, tmp_log):
                if os.path.exists(leftover):
                    os.unlink(leftover)
    return ctypes.CDLL(str(lib_path)), log_path.read_text()


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def on_device(device):
    """A context that makes the CUDA ``device`` current for a launch:
    ``torch.cuda.device(device)`` when another device is current, else a
    no-op (entering ``torch.cuda.device`` costs host time on every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launch.
    (``torch.cuda.current_stream(device).cuda_stream`` builds a Stream
    object on every call, several microseconds of host time.)"""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
