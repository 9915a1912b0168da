"""Wrapper of the decode-attention CUDA kernel.

``decode_attention(q, k_cache, v_cache, slot_pos, cur_pos)`` dispatches on
the tensors' device: CPU tensors take the plain version (``ref.py``); CUDA
tensors launch the kernel (``decode_attention.cu``, built at first use) or
raise.  Nothing falls back from one to the other.
``decode_attention.launches`` counts kernel launches (plain-version calls
do not count), so a run can show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = pathlib.Path(__file__).with_name("decode_attention.cu")
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``; later calls in the
    process return the same pair without touching the source."""
    lib, log = build.load(SOURCE)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [vp] * 6 + [i] * 6 + [f, i, vp]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_supports_dim.argtypes = [i]
    lib.decode_attention_supports_dim.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib, log


def _check(q, k_cache, v_cache, slot_pos, cur_pos, window):
    tensors = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("slot_pos", slot_pos), ("cur_pos", cur_pos))
    for name, t in tensors:
        want = DTYPES if name in ("q", "k_cache", "v_cache") \
            else (torch.int32,)
        if t.dtype not in want:
            raise TypeError(f"decode_attention: {name} must be one of "
                            f"{want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q is on {q.device}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: q, k_cache and v_cache must "
                        f"share a dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    ok = q.ndim == 3 and k_cache.ndim == 4 \
        and k_cache.shape == v_cache.shape
    if ok:
        B, H, dh = q.shape
        _, KV, S, _ = k_cache.shape
        ok = (B >= 1 and S >= 1 and KV >= 1 and H % KV == 0
              and k_cache.shape[0] == B and k_cache.shape[3] == dh
              and tuple(slot_pos.shape) == (B, S)
              and tuple(cur_pos.shape) == (B,))
    if not ok:
        raise ValueError(
            "decode_attention: want q (B, H, dh), caches (B, KV, S, dh) with "
            "H % KV == 0, slot_pos (B, S), cur_pos (B,); got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}, {tuple(slot_pos.shape)}, "
            f"{tuple(cur_pos.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"decode_attention: window must be >= 0, got "
                         f"{window}")


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window=None,
                     softmax_scale=None):
    """One query token per (row, head) against the row's KV cache.

    q: (B, H, dh); k_cache, v_cache: (B, KV, S, dh), all float32 or all
    bfloat16; slot_pos: (B, S) int32, the position each slot holds (-1:
    unwritten); cur_pos: (B,) int32; all contiguous on one device.  Head h
    reads KV head ``h // (H // KV)``.  Returns (B, H, dh) in q's dtype."""
    _check(q, k_cache, v_cache, slot_pos, cur_pos, window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, slot_pos, cur_pos,
                                    window=window,
                                    softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    lib, _ = load_library()
    B, H, dh = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if not lib.decode_attention_supports_dim(dh):
        raise ValueError(f"decode_attention: head dim {dh} is not one the "
                         "kernel is built for (16, 32, 64, 128)")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: q and the caches must start on "
                         "a 16-byte boundary")
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
            B, H, KV, S, dh, -1 if window is None else int(window),
            float(scale), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("decode_attention: kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}"
                           f" (CUDA error {rc})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
