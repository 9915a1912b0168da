"""Least time an H100 could take for each ported kernel's function.

The bound of a call is the larger of two times: the bytes the function
must move (each input read once, each output written once) over the HBM
rate, and the floating-point operations it does on those inputs over the
peak rate for their type.  Elementwise work, reductions and fp32 products
count against the fp32 peak; a product of bf16 inputs counts against the
bf16 dense tensor-core peak, the least time the card could take for it.
Published H100 SXM figures (NVIDIA data sheet, dense, at the full 700 W):
3.35 TB/s of HBM3, 67 TFLOP/s fp32, 989 TFLOP/s bf16 on the tensor cores.
``chip_smoke.py`` sets these bounds beside each kernel's measured time.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12


def bound_ms(bytes_: float, flops: float,
             flops_per_s: float = FP32_FLOPS) -> tuple:
    """(least time in ms, "bytes" or "operations": which of the two sets
    it)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def _product_rate(itemsize):
    """The peak for products of inputs of ``itemsize`` bytes: bf16 on the
    tensor cores, fp32 on the CUDA cores."""
    return BF16_TENSOR_FLOPS if itemsize == 2 else FP32_FLOPS


def rmsnorm(N, d, itemsize):
    """x (N, d) and scale (d,) read, out (N, d) written, in x's dtype; 4
    flops an element (square, sum, the two products)."""
    return bound_ms(itemsize * (2 * N * d + d), 4 * N * d)


def attention_pairs(S, causal, window):
    """(query, key) pairs that a query of a length-S sequence keeps: keys
    at or before it when ``causal``, and ``q - k < window`` when a window
    is given."""
    n = 0
    for i in range(S):
        lo = 0 if window is None else max(0, i - window + 1)
        hi = i if causal else S - 1
        n += max(0, hi - lo + 1)
    return n


def flash_attention(B, H, KV, S, dh, itemsize, causal, window):
    """q (B, H, S, dh), k and v (B, KV, S, dh) read and the output written
    in their dtype; 4 dh flops for each kept (query, key) pair of every
    query head (scores and weighted sum), counted against the product
    rate of the inputs' type."""
    return bound_ms(itemsize * (2 * B * H * S * dh + 2 * B * KV * S * dh),
                    4 * dh * B * H * attention_pairs(S, causal, window),
                    _product_rate(itemsize))


def mlstm_chunk(B, H, L, dh, itemsize):
    """q, k, v (B, H, L, dh) read and h written in their dtype; the gates,
    C0, n0, m0 read and C1, n1, m1 written in fp32.  Per (batch, head): 4 dh
    flops for each of the L (L + 1) / 2 causal (t, s) pairs, 4 L dh^2 for
    q C0 and the k v^T update, 4 L dh for the n terms; counted against the
    product rate of q's type."""
    bytes_ = B * H * (itemsize * 4 * L * dh
                      + 4 * (2 * L + 2 * dh * dh + 2 * dh + 2))
    flops = B * H * (4 * dh * L * (L + 1) // 2 + 4 * L * dh * dh
                     + 4 * L * dh)
    return bound_ms(bytes_, flops, _product_rate(itemsize))
