"""Wrapper of the fused exit-confidence CUDA kernel.

``exit_confidence(h, scale, w_out)`` dispatches on the tensors' device: CPU
tensors take the plain version (``ref.py``); CUDA tensors launch the kernel
(``exit_confidence.cu``, built at first use) or raise.  Nothing falls back
from one to the other.  ``exit_confidence.launches`` counts kernel launches
(plain-version calls do not count), so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref

SOURCE = pathlib.Path(__file__).with_name("exit_confidence.cu")


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``; later calls in the
    process return the same pair without touching the source."""
    lib, log = build.load(SOURCE)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.exit_confidence_launch.argtypes = [vp] * 10 + [i, i, i, f, f, vp]
    lib.exit_confidence_launch.restype = i
    lib.exit_confidence_slab_width.argtypes = []
    lib.exit_confidence_slab_width.restype = i
    lib.exit_confidence_max_dim.argtypes = []
    lib.exit_confidence_max_dim.restype = i
    lib.exit_confidence_error_string.argtypes = [i]
    lib.exit_confidence_error_string.restype = ctypes.c_char_p
    return lib, log


def _check(h, scale, w_out):
    for name, t in (("h", h), ("scale", scale), ("w_out", w_out)):
        if t.dtype != torch.float32:
            raise TypeError(f"exit_confidence: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"exit_confidence: {name} must be contiguous")
        if t.device != h.device:
            raise ValueError(f"exit_confidence: {name} is on {t.device}, "
                             f"h is on {h.device}")
    if h.ndim != 2 or scale.ndim != 1 or w_out.ndim != 2 \
            or scale.shape[0] != h.shape[1] or w_out.shape[0] != h.shape[1] \
            or h.shape[0] < 1 or w_out.shape[1] < 1:
        raise ValueError("exit_confidence: want h (N, d), scale (d,), "
                         f"w_out (d, V); got {tuple(h.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(w_out.shape)}")


def exit_confidence(h, scale, w_out, *, eps: float = 1e-6,
                    temperature: float = 1.0):
    """Fused RMSNorm → ``@ w_out / temperature`` → (conf, pred, max, lse).

    h: (N, d), scale: (d,), w_out: (d, V), all float32 and contiguous on
    one device.  Returns (conf (N,), pred (N,) int32, max_logit (N,),
    lse (N,))."""
    _check(h, scale, w_out)
    if h.device.type == "cpu":
        return exit_confidence_ref(h, scale, w_out, eps=eps,
                                   temperature=temperature)
    if h.device.type != "cuda":
        raise ValueError(f"exit_confidence: no kernel for device {h.device}")
    lib, _ = load_library()
    N, d = h.shape
    V = w_out.shape[1]
    if d > lib.exit_confidence_max_dim():
        raise ValueError(f"exit_confidence: d={d} exceeds the kernel's "
                         f"limit of {lib.exit_confidence_max_dim()}")
    n_slabs = -(-V // lib.exit_confidence_slab_width())
    with torch.cuda.device(h.device):
        # rows: conf, pred (int32 bits), max_logit, lse; and the per-slab
        # partials (max, sum, argmax bits) of pass 1 — two allocations
        out = torch.empty(4, N, dtype=torch.float32, device=h.device)
        part = torch.empty(3, N, n_slabs, dtype=torch.float32,
                           device=h.device)
        conf, pred = out[0], out[1].view(torch.int32)
        max_logit, lse = out[2], out[3]
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.exit_confidence_launch(
            h.data_ptr(), scale.data_ptr(), w_out.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
            conf.data_ptr(), pred.data_ptr(), max_logit.data_ptr(),
            lse.data_ptr(), N, d, V, float(eps), float(temperature), stream)
    if rc != 0:
        raise RuntimeError("exit_confidence: kernel launch failed: "
                           f"{lib.exit_confidence_error_string(rc).decode()}"
                           f" (CUDA error {rc})")
    exit_confidence.launches += 1
    return conf, pred, max_logit, lse


exit_confidence.launches = 0
