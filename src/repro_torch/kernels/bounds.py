"""Least time an H100 could take for each ported kernel's function.

The bound of a call is the larger of two times: the bytes the function
must move (each input read once, each output written once) over the HBM
rate, and the floating-point operations it does on those inputs over the
peak rate for their type.  The kernels of the port do their arithmetic in
fp32 on the CUDA cores, so the operations are counted against the fp32
peak.  Published H100 SXM figures (NVIDIA data sheet, dense, at the full
700 W): 3.35 TB/s of HBM3, 67 TFLOP/s fp32.  ``chip_smoke.py`` sets these
bounds beside each kernel's measured time.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def bound_ms(bytes_: float, flops: float) -> tuple:
    """(least time in ms, "bytes" or "operations": which of the two sets
    it)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def exit_confidence(n, d, v, itemsize=4):
    """h (n, d), scale (d,), w_out (d, v) read; conf, pred, max, lse (n,)
    fp32 written; 2 n d v flops."""
    return bound_ms(itemsize * (n * d + d + d * v) + 4 * 4 * n,
                    2 * n * d * v)


def decode_attention(B, H, KV, S, dh, itemsize):
    """q (B, H, dh), k and v (B, KV, S, dh) read and the output (B, H, dh)
    written in their dtype, slot_pos (B, S) and cur_pos (B,) int32 read;
    4 B H S dh flops (scores and weighted sum).  Every slot is counted, as
    when every slot is valid."""
    return bound_ms(itemsize * (2 * B * H * dh + 2 * B * KV * S * dh)
                    + 4 * (B * S + B), 4 * B * H * S * dh)
