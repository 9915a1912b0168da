"""Wrapper of the decode-attention CUDA kernels.

``decode_attention(q, k_cache, v_cache, slot_pos, cur_pos)`` dispatches on
the tensors' device: CPU tensors take the plain version (``ref.py``); CUDA
tensors launch the kernels (``decode_attention.cu``, built at first use) or
raise.  Nothing falls back from one to the other.

On the card a call is two launches (flash-decoding): a partial pass whose
blocks each own ``split_slots(S)`` consecutive cache slots of one (row, KV
head), reading only the parts of the cache that hold a valid slot with
asynchronous bulk copies, then a pass that combines the splits of each
(row, head) in index order.  The split length depends on S alone, never on
the batch, so a row's result is bitwise the same whatever else is in its
batch.  The wrapper allocates the partials' fp32 scratch (B, H, ceil(S /
split), dh + 2).  The kernels are bound by the bytes of the cache.
``decode_attention.launches`` counts wrapper calls that launched the
kernels (plain-version calls do not count), so a run can show that its
main path went through them.
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
#: head dims the kernels are built for
KERNEL_DIMS = (16, 32, 64, 128)


def split_slots(S):
    """Cache slots a partial block owns, from the cache length alone: 128 up
    to S 1024, 256 above (the kernels take no other).  Device times on the
    H100 at qwen3-4b's heads in bf16 (``tools/attention_probe.py time``):
    split 128 is the faster at S 256 and 1024 (B 1, 2 and 8), split 256 at
    S 2048 and 4096 (B 8)."""
    return 128 if S <= 1024 else 256


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library; declares the C
    signatures.  Returns ``(ctypes.CDLL, nvcc_output)``; later calls in the
    process return the same pair without touching the source."""
    lib, log = build.load(SOURCE)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [vp] * 8 + [i] * 6 + [f, i, i,
                                                                 vp]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib, log


def check(q, k_cache, v_cache, slot_pos, cur_pos, window, *, kernel=False):
    """Raise on anything the wrapper does not take: q (B, H, dh), caches
    (B, KV, S, dh) with H % KV == 0, one dtype (fp32 or bf16), slot_pos
    (B, S) and cur_pos (B,) int32, all contiguous on one device; window None
    or >= 0.  ``kernel``: also what only the CUDA kernels need (dh in
    ``KERNEL_DIMS``; q and the caches on a 16-byte boundary, which the bulk
    copies of cache rows need)."""
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
    if kernel:
        if q.shape[2] not in KERNEL_DIMS:
            raise ValueError(f"decode_attention: head dim {q.shape[2]} is "
                             f"not one the kernel is built for "
                             f"{KERNEL_DIMS}")
        if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
            raise ValueError("decode_attention: q and the caches must start "
                             "on a 16-byte boundary")


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window=None,
                     softmax_scale=None):
    """One query token per (row, head) against the row's KV cache.

    q: (B, H, dh); k_cache, v_cache: (B, KV, S, dh), all float32 or all
    bfloat16; slot_pos: (B, S) int32, the position each slot holds (-1:
    unwritten); cur_pos: (B,) int32; all contiguous on one device.  Head h
    reads KV head ``h // (H // KV)``.  Returns (B, H, dh) in q's dtype."""
    check(q, k_cache, v_cache, slot_pos, cur_pos, window,
          kernel=q.device.type == "cuda")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, slot_pos, cur_pos,
                                    window=window,
                                    softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    out = launch(q, k_cache, v_cache, slot_pos, cur_pos, window=window,
                 softmax_scale=softmax_scale,
                 split=split_slots(k_cache.shape[2]))
    decode_attention.launches += 1
    return out


def launch(q, k_cache, v_cache, slot_pos, cur_pos, *, window, softmax_scale,
           split):
    """Launch the two kernels on checked CUDA tensors with ``split`` slots
    a partial block (128 or 256); ``decode_attention`` calls it with
    ``split_slots(S)``.  Returns (B, H, dh) in q's dtype."""
    lib, _ = load_library()
    B, H, dh = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    n_splits = -(-S // split)
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        # the partials in one allocation: acc (B, H, n_splits, dh), then
        # (m, l) (B, H, n_splits, 2)
        part = torch.empty(B * H * n_splits * (dh + 2), dtype=torch.float32,
                           device=q.device)
        part_acc = part.data_ptr()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
            part_acc, part_acc + 4 * B * H * n_splits * dh, B, H, KV, S, dh,
            -1 if window is None else int(window), float(scale),
            int(q.dtype == torch.bfloat16), int(split), stream)
    if rc != 0:
        raise RuntimeError("decode_attention: kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}"
                           f" (CUDA error {rc})")
    return out


decode_attention.launches = 0
