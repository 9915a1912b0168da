"""Plain PyTorch version of the fused exit-confidence kernel.

It materialises the (N, V) logits and reduces them with the kernel's
finisher arithmetic (max m, l = max(Σ exp(logits - m), 1e-30), conf = 1/l,
lse = m + log l), as ``repro.models.exits.exit_stats_unfused`` does.  The
wrapper in ``ops.py`` runs it for CPU tensors, and ``chip_smoke.py`` holds
the CUDA kernels against it on the card.

``exit_confidence_ref_split`` is a test-only model of the bf16 kernel's
numerics: the normalised rows hn split into bf16 hi = bf16(hn) and lo =
bf16(hn - hi), and the logits taken as (hi + lo) @ W_out, as the
tensor-core kernel multiplies hi and lo into one fp32 accumulator (hi + lo
is exact in fp32).  The wrapper never calls it.
"""
from __future__ import annotations

import torch


def exit_confidence_ref(h_rows, scale, w_out, *, eps: float = 1e-6,
                        temperature: float = 1.0):
    """h_rows: (N, d); scale: (d,); w_out: (d, V).

    Returns (conf (N,), pred (N,) int32, max_logit (N,), lse (N,))."""
    return _reduce(_normalise(h_rows, scale, eps) @ w_out.float(),
                   temperature)


def exit_confidence_ref_split(h_rows, scale, w_out, *, eps: float = 1e-6,
                              temperature: float = 1.0):
    """``exit_confidence_ref`` with hn held as bf16 hi + lo (test-only)."""
    hn = _normalise(h_rows, scale, eps)
    hi = hn.to(torch.bfloat16).float()
    lo = (hn - hi).to(torch.bfloat16).float()
    return _reduce((hi + lo) @ w_out.float(), temperature)


def _normalise(h_rows, scale, eps):
    h = h_rows.float()
    var = h.square().mean(-1, keepdim=True)
    return h * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _reduce(logits, temperature):
    logits = logits / temperature
    m = logits.max(dim=1).values
    l = torch.clamp(torch.exp(logits - m[:, None]).sum(dim=1), min=1e-30)
    conf = 1.0 / l
    pred = torch.argmax(logits, dim=1).to(torch.int32)
    return conf, pred, m, m + torch.log(l)
