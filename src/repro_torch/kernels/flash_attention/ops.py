"""Wrapper of the flash-attention CUDA kernels.

``flash_attention(q, k, v, causal=True, window=None, softmax_scale=None)``
dispatches on the tensors' device: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch a kernel of ``flash_attention.cu``
(built at first use) or raise.  Nothing falls back from one to the other.

bf16 tensors launch the tensor-core kernel: blocks of 128 query rows of
one head (two warpgroups), K and V tiles brought by TMA into a
shared-memory ring, both products on ``wgmma`` with fp32 accumulators;
P is rounded to bf16 for the P V product (``ref.py``'s
``flash_attention_ref_bf16_p`` models that).  At prefill lengths the bf16
tensor-core rate bounds it.  fp32 tensors launch the fp32 kernel, whose
products run on the CUDA cores.  The JAX function's ``block_q`` /
``block_k`` are tile choices, not semantics: the kernels pick their own
tiles.  ``flash_attention.launches`` counts kernel launches (plain-version
calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = pathlib.Path(__file__).with_name("flash_attention.cu")
DTYPES = (torch.float32, torch.bfloat16)
#: head dims the kernel is built for
KERNEL_DIMS = (16, 32, 64, 128)
#: query rows of a bf16 (tensor-core) block; its grid has ceil(S / 128)
#: rows, at most 65535
BF16_BLOCK_Q = 128


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``."""
    lib, log = build.load(SOURCE)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 7 + [f, i, vp]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib, log


def check(q, k, v, window, *, kernel=False):
    """Raise on anything the wrapper does not take: q (B, H, S, dh), k and
    v (B, KV, S, dh) with H % KV == 0, one dtype (fp32 or bf16), contiguous,
    on one device; window None or >= 0.  ``kernel``: also what only the
    CUDA kernels need (dh in ``KERNEL_DIMS``, B * KV < 65536, 16-byte
    aligned tensors, which the TMA loads of the bf16 kernel need too, and
    in bf16 ceil(S / 128) < 65536)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} must be one of "
                            f"{DTYPES}, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}; all three must share a dtype")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"is on {q.device}")
    ok = q.ndim == 4 and k.ndim == 4 and k.shape == v.shape
    if ok:
        B, H, S, dh = q.shape
        KV = k.shape[1]
        ok = (min(B, H, S, dh, KV) >= 1 and H % KV == 0
              and (k.shape[0], k.shape[2], k.shape[3]) == (B, S, dh))
    if not ok:
        raise ValueError("flash_attention: want q (B, H, S, dh), k and v "
                         "(B, KV, S, dh) with H % KV == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if kernel:
        if dh not in KERNEL_DIMS:
            raise ValueError(f"flash_attention: head dim {dh} is not one "
                             f"the kernel is built for {KERNEL_DIMS}")
        if B * KV > 65535:
            raise ValueError(f"flash_attention: B * KV = {B * KV} exceeds "
                             "the kernel's grid (65535)")
        if q.dtype == torch.bfloat16 and -(-S // BF16_BLOCK_Q) > 65535:
            raise ValueError(f"flash_attention: S = {S} exceeds the bf16 "
                             f"kernel's grid ({65535 * BF16_BLOCK_Q})")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: q, k and v must start on a "
                             "16-byte boundary")


def flash_attention(q, k, v, *, causal=True, window=None,
                    softmax_scale=None):
    """Prefill attention with GQA: query head h reads KV head
    ``h // (H // KV)``.

    q: (B, H, S, dh); k, v: (B, KV, S, dh); all float32 or all bfloat16,
    contiguous, on one device.  ``causal`` masks keys after the query;
    ``window`` keeps keys with ``q - k < window``.  Returns (B, H, S, dh)
    in q's dtype; a row with no visible key is zeros."""
    check(q, k, v, window, kernel=q.device.type == "cuda")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    lib, _ = load_library()
    B, H, S, dh = q.shape
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], S, dh, int(bool(causal)),
            -1 if window is None else int(window), float(scale),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("flash_attention: kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}"
                           f" (CUDA error {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
