"""Wrapper of the RMSNorm CUDA kernel.

``rmsnorm(x, scale, eps=1e-6)`` dispatches on the tensors' device: CPU
tensors take the plain version (``ref.py``); CUDA tensors launch the kernel
(``rmsnorm.cu``, built at first use) or raise.  Nothing falls back from
one to the other.  ``rmsnorm.launches`` counts kernel launches
(plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

SOURCE = pathlib.Path(__file__).with_name("rmsnorm.cu")
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``."""
    lib, log = build.load(SOURCE)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rmsnorm_launch.argtypes = [vp] * 3 + [i, i, f, i, i, vp]
    lib.rmsnorm_launch.restype = i
    lib.rmsnorm_error_string.argtypes = [i]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib, log


def check(x, scale):
    """Raise on anything the kernel does not take: x (N, d) fp32 or bf16,
    scale (d,) fp32 or x's dtype, both contiguous on one device."""
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: x must be one of {DTYPES}, got {x.dtype}")
    if scale.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rmsnorm: scale must be float32 or x's dtype "
                        f"{x.dtype}, got {scale.dtype}")
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} must be contiguous")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale is on {scale.device}, x is on "
                         f"{x.device}")
    if x.ndim != 2 or scale.ndim != 1 or scale.shape[0] != x.shape[1] \
            or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"rmsnorm: want x (N, d) and scale (d,) with N, d "
                         f">= 1; got {tuple(x.shape)}, {tuple(scale.shape)}")


def rmsnorm(x, scale, *, eps=1e-6):
    """``x * rsqrt(mean(x²) + eps) * (1 + scale)`` per row, in fp32.

    x: (N, d), float32 or bfloat16; scale: (d,), float32 or x's dtype; both
    contiguous on one device.  Returns (N, d) in x's dtype."""
    check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rmsnorm: x and scale must start on a 16-byte "
                         "boundary")
    lib, _ = load_library()
    N, d = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), N, d, float(eps),
            int(x.dtype == torch.bfloat16),
            int(scale.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("rmsnorm: kernel launch failed: "
                           f"{lib.rmsnorm_error_string(rc).decode()} "
                           f"(CUDA error {rc})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
