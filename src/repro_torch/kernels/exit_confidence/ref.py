"""Plain PyTorch version of the fused exit-confidence kernel.

It materialises the (N, V) logits and reduces them with the kernel's
finisher arithmetic (max m, l = max(Σ exp(logits - m), 1e-30), conf = 1/l,
lse = m + log l), as ``repro.models.exits.exit_stats_unfused`` does.  The
wrapper in ``ops.py`` runs it for CPU tensors, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def exit_confidence_ref(h_rows, scale, w_out, *, eps: float = 1e-6,
                        temperature: float = 1.0):
    """h_rows: (N, d); scale: (d,); w_out: (d, V).

    Returns (conf (N,), pred (N,) int32, max_logit (N,), lse (N,))."""
    h = h_rows.float()
    var = h.square().mean(-1, keepdim=True)
    hn = h * torch.rsqrt(var + eps) * (1.0 + scale.float())
    logits = (hn @ w_out.float()) / temperature
    m = logits.max(dim=1).values
    l = torch.clamp(torch.exp(logits - m[:, None]).sum(dim=1), min=1e-30)
    conf = 1.0 / l
    pred = torch.argmax(logits, dim=1).to(torch.int32)
    return conf, pred, m, m + torch.log(l)
