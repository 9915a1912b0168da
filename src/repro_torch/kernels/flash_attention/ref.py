"""Plain PyTorch version of the flash-attention kernel.

It computes what the Pallas kernel ``_attn_kernel``
(``repro.kernels.flash_attention.kernel``) computes, in fp32: scores
``scale * q . k`` over the keys of the query head's KV head (GQA, head h
reads KV head ``h // (H // KV)``), masked by ``q >= k`` when causal and by
``q - k < window`` when a window is given (no lower bound without causal),
a softmax whose max starts at -1e30 and whose sum is clamped at 1e-30.  A
row with no visible key (``window=0``) gives zeros, as the Pallas kernel
does; the JAX package's ``flash_attention_ref`` gives a uniform average
there.  The wrapper in ``ops.py`` runs it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None,
                        softmax_scale=None):
    """q: (B, H, S, dh); k, v: (B, KV, S, dh).  Returns (B, H, S, dh) in
    q's dtype."""
    B, H, S, dh = q.shape
    KV = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = q.reshape(B, KV, H // KV, S, dh).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    m = torch.where(mask, s, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / l
    return o.reshape(B, H, S, dh).to(q.dtype)
