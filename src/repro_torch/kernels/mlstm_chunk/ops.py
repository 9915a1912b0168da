"""Wrapper of the mLSTM chunk CUDA kernel.

``mlstm_chunk(q, k, v, i_pre, f_pre, C0, n0, m0)`` dispatches on the
tensors' device: CPU tensors take the plain version (``ref.py``); CUDA
tensors launch the kernel (``mlstm_chunk.cu``, built at first use) or
raise.  Nothing falls back from one to the other.  The gates and the state
are cast to contiguous fp32 first, as the JAX wrapper casts the state.
``mlstm_chunk.launches`` counts kernel launches (plain-version calls do
not count).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

SOURCE = pathlib.Path(__file__).with_name("mlstm_chunk.cu")
DTYPES = (torch.float32, torch.bfloat16)
#: head dims and the longest chunk the kernel is built for
KERNEL_DIMS = (8, 16, 32, 64)
KERNEL_MAX_L = 128


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``."""
    lib, log = build.load(SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mlstm_chunk_launch.argtypes = [vp] * 12 + [i] * 4 + [vp]
    lib.mlstm_chunk_launch.restype = i
    lib.mlstm_chunk_error_string.argtypes = [i]
    lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
    return lib, log


def check(q, k, v, i_pre, f_pre, C0, n0, m0, *, kernel=False):
    """Raise on anything the wrapper does not take: q, k, v (B, H, L, dh)
    of one dtype (fp32 or bf16), contiguous; floating gates (B, H, L) and
    state C0 (B, H, dh, dh), n0 (B, H, dh), m0 (B, H); all on one device.
    ``kernel``: also what only the CUDA kernel needs (dh in
    ``KERNEL_DIMS``, L <= ``KERNEL_MAX_L``, 16-byte aligned q, k, v)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"mlstm_chunk: {name} must be one of {DTYPES}, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"mlstm_chunk: {name} is {t.dtype}, q is "
                            f"{q.dtype}; all three must share a dtype")
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunk: {name} must be contiguous")
    named = (("q", q), ("k", k), ("v", v), ("i_pre", i_pre),
             ("f_pre", f_pre), ("C0", C0), ("n0", n0), ("m0", m0))
    for name, t in named[3:]:
        if not t.is_floating_point():
            raise TypeError(f"mlstm_chunk: {name} must be floating, got "
                            f"{t.dtype}")
    for name, t in named[1:]:
        if t.device != q.device:
            raise ValueError(f"mlstm_chunk: {name} is on {t.device}, q is "
                             f"on {q.device}")
    ok = q.ndim == 4 and min(q.shape) >= 1
    if ok:
        B, H, L, dh = q.shape
        want = {"k": (B, H, L, dh), "v": (B, H, L, dh), "i_pre": (B, H, L),
                "f_pre": (B, H, L), "C0": (B, H, dh, dh), "n0": (B, H, dh),
                "m0": (B, H)}
        ok = all(tuple(t.shape) == want[name] for name, t in named[1:])
    if not ok:
        raise ValueError(
            "mlstm_chunk: want q, k, v (B, H, L, dh), i_pre and f_pre "
            "(B, H, L), C0 (B, H, dh, dh), n0 (B, H, dh), m0 (B, H); got "
            + ", ".join(f"{name} {tuple(t.shape)}" for name, t in named))
    if kernel:
        if dh not in KERNEL_DIMS or L > KERNEL_MAX_L:
            raise ValueError(f"mlstm_chunk: the kernel takes dh in "
                             f"{KERNEL_DIMS} and L <= {KERNEL_MAX_L}; got "
                             f"dh {dh}, L {L}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("mlstm_chunk: q, k and v must start on a "
                             "16-byte boundary")


def mlstm_chunk(q, k, v, i_pre, f_pre, C0, n0, m0):
    """One chunk of the stabilised mLSTM for every (batch, head).

    q, k, v: (B, H, L, dh), float32 or bfloat16; i_pre, f_pre: (B, H, L);
    C0: (B, H, dh, dh); n0: (B, H, dh); m0: (B, H) (-1e30 for a fresh
    state); all on one device.  Returns ``(h, C1, n1, m1)``: h (B, H, L,
    dh) in q's dtype, the state at the chunk's end in fp32."""
    check(q, k, v, i_pre, f_pre, C0, n0, m0)
    i_pre, f_pre, C0, n0, m0 = (t.float().contiguous()
                                for t in (i_pre, f_pre, C0, n0, m0))
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, i_pre, f_pre, C0, n0, m0)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk: no kernel for device {q.device}")
    check(q, k, v, i_pre, f_pre, C0, n0, m0, kernel=True)
    lib, _ = load_library()
    B, H, L, dh = q.shape
    with torch.cuda.device(q.device):
        h = torch.empty_like(q)
        C1, n1, m1 = (torch.empty_like(t) for t in (C0, n0, m0))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mlstm_chunk_launch(
            *(t.data_ptr() for t in (q, k, v, i_pre, f_pre, C0, n0, m0, h,
                                     C1, n1, m1)),
            B * H, L, dh, int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("mlstm_chunk: kernel launch failed: "
                           f"{lib.mlstm_chunk_error_string(rc).decode()} "
                           f"(CUDA error {rc})")
    mlstm_chunk.launches += 1
    return h, C1, n1, m1


mlstm_chunk.launches = 0
